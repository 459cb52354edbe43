"""The Threshold Algorithm (paper Algorithm 2), item at a time, in numpy.

:func:`threshold_topk_np` is the paper-faithful oracle: it pops the R
list heads of round d, scores each item the first time it is seen, and
stops once the running K-th best reaches the round's Eq. 3 bound
``sum_r u_r * t_r(y_{L_r(d)})``. It counts the score evaluations (the
paper's cost metric) and the list depth. The Block Threshold Algorithm at
``block_size=1`` (:func:`repro_torch.core.blocked.blocked_topk`) must
reproduce its values, ids, ``n_scored`` and depth.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

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
