"""The Threshold Algorithm (paper Algorithm 2).

:func:`threshold_topk_np` is the paper-faithful oracle, item at a time in
numpy: it pops the R list heads of round d, scores each item the first
time it is seen, and stops once the running K-th best reaches the round's
Eq. 3 bound ``sum_r u_r * t_r(y_{L_r(d)})``. It counts the score
evaluations (the paper's cost metric) and the list depth.

:func:`threshold_topk` and its index forms are TA on tensors, one list
depth a step: the batched gather scan of
:mod:`repro_torch.core.blocked` at ``block_size=1``, freshness from the
index's inverse permutations, its tail scored by kernel B4 on the card.
The ``ta`` registry engine runs the chunked form
(:func:`repro_torch.core.blocked.chunked_ta_topk`). All reproduce the
oracle's values, ids, ``n_scored`` and depth.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.index import TopKIndex
from repro_torch.core.naive import TopKResult

NEG_INF = float("-inf")


class TAStats(NamedTuple):
    n_scored: int          # number of full score evaluations s(x, y)
    depth: int             # list depth at termination
    lower_bounds: np.ndarray  # lower bound trajectory per round (Fig. 3)
    upper_bounds: np.ndarray  # upper bound trajectory per round
    found_at: int          # first round at which the final top-K set was held


def _query_order_np(order_desc: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Flip list direction for negative query weights."""
    order = order_desc.copy()
    for r in range(order.shape[0]):
        if u[r] < 0:
            order[r] = order[r][::-1]
    return order


def threshold_topk_np(
    T: np.ndarray,
    order_desc: np.ndarray,
    u: np.ndarray,
    k: int,
    track_trajectory: bool = False,
) -> Tuple[np.ndarray, np.ndarray, TAStats]:
    """Faithful TA. Returns (values[k], indices[k], stats).

    Sparse queries: lists whose query weight is exactly zero are never
    walked (their Eq. 3 bound terms are zero), per the paper's Section 2
    sparse-data discussion.
    """
    M, R = T.shape
    k = min(k, M)
    order = _query_order_np(order_desc, u)
    active = np.nonzero(u)[0]

    calculated = np.zeros(M, dtype=bool)
    top_vals = np.full(k, NEG_INF)
    top_ids = np.full(k, -1, dtype=np.int64)
    n_scored = 0
    lower, upper = NEG_INF, np.inf
    lbs, ubs = [], []
    # trajectory of the current top-K set to find "correct top found" round
    sets_per_round = [] if track_trajectory else None

    d = 0
    while lower < upper and d < M:
        upper = 0.0
        for r in active:
            y = order[r, d]
            upper += u[r] * T[y, r]
            if not calculated[y]:
                calculated[y] = True
                score = float(u @ T[y])
                n_scored += 1
                if score > top_vals[-1]:
                    # insert keeping descending order (a heap in the paper)
                    pos = np.searchsorted(-top_vals, -score)
                    top_vals = np.insert(top_vals, pos, score)[:k]
                    top_ids = np.insert(top_ids, pos, y)[:k]
        lower = top_vals[-1]
        lbs.append(lower)
        ubs.append(upper)
        if sets_per_round is not None:
            sets_per_round.append(frozenset(top_ids.tolist()))
        d += 1

    found_at = d
    if sets_per_round is not None:
        final = sets_per_round[-1]
        for i, s in enumerate(sets_per_round):
            if s == final:
                found_at = i + 1
                break
    stats = TAStats(
        n_scored=n_scored,
        depth=d,
        lower_bounds=np.asarray(lbs),
        upper_bounds=np.asarray(ubs),
        found_at=found_at,
    )
    return top_vals, top_ids, stats


# ---------------------------------------------------------------------------
# TA on tensors: one list depth a step over the batched gather scan
# ---------------------------------------------------------------------------
# ``blocked`` and ``strategies`` import this module, so it imports
# ``blocked`` inside the functions.


def threshold_topk(
    targets: torch.Tensor,
    order: torch.Tensor,
    t_sorted: torch.Tensor,
    u: torch.Tensor,
    k: int,
    max_rounds: int = -1,
    rank_desc: torch.Tensor = None,
) -> TopKResult:
    """TA of one query ``u: [R]``, one list depth a step.

    ``order``/``t_sorted`` are the index's DESCENDING arrays
    (``order_desc``/``t_sorted_desc``); negative weights walk their lists
    backwards by index arithmetic. ``max_rounds`` is the halted TA's
    budget (``-1``: exact). ``rank_desc`` (the index's inverse
    permutations) answers freshness; it is worked out from ``order`` when
    absent. ``depth`` is in rounds.
    """
    from repro_torch.core.blocked import _chunked_ta_gather, _rank_by_item
    rank_by_item = (_rank_by_item(order) if rank_desc is None
                    else rank_desc.T)
    res = _chunked_ta_gather(targets, order, t_sorted, rank_by_item,
                             u[None, :], k, 1, max_rounds, None)
    return TopKResult(*(x[0] for x in res))


def threshold_topk_from_index(targets: torch.Tensor, index: TopKIndex,
                              u: torch.Tensor, k: int,
                              max_rounds: int = -1) -> TopKResult:
    return threshold_topk(targets, index.order_desc, index.t_sorted_desc,
                          u, k, max_rounds, rank_desc=index.rank_desc)


def threshold_topk_batched_from_index(
    targets: torch.Tensor, index: TopKIndex, U: torch.Tensor, k: int,
    chunk: int = 1, max_rounds: int = -1, layout=None,
) -> TopKResult:
    """Batched TA: the batch-native prefix scan when ``layout`` serves
    the batch's sign bucket (``chunk`` rounds a step), else TA rounds by
    the batched gather scan. Each query's result and counts equal its own
    :func:`threshold_topk_from_index`."""
    from repro_torch.core.blocked import (_chunked_ta_gather,
                                          chunked_ta_topk_batched_native)
    from repro_torch.core.strategies import sign_bucket
    U = torch.atleast_2d(torch.as_tensor(U, dtype=targets.dtype,
                                         device=targets.device))
    chunk = max(chunk, 1)
    if layout is not None and layout.prefix_steps(chunk) > 0:
        sign, dense = sign_bucket(U)
        if layout.serves_sign(sign):
            return chunked_ta_topk_batched_native(
                targets, index.order_desc, index.t_sorted_desc, U, k,
                chunk=chunk, max_rounds=max_rounds, layout=layout,
                sign=sign, dense=dense)
    return _chunked_ta_gather(targets, index.order_desc, index.t_sorted_desc,
                              index.rank_desc.T, U, k, 1, max_rounds, None)
