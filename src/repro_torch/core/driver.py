"""Top-K merges and the pruned-scan drivers of the list engines.

Every exact scan is one state machine::

    while lower_bound < upper_bound and blocks remain:
        ids    <- enumerate the next block of candidates
        scores <- score the fresh candidates against the query
        top-K  <- merge
        bounds <- tighten (lower = running K-th best; upper = strategy bound)

:func:`batched_pruned_scan` runs it for a batch that shares its
enumeration, parameterised by a strategy
(:mod:`repro_torch.core.strategies`); one query is the batch of one. The
reference writes it as a ``lax.while_loop``; here it is a Python loop
over device tensors whose continuation test reads one boolean back to the
host per step (one device-to-host synchronisation per block, accepted in
this slice, as in the ``norm`` scan). Only single-round steps are ported:
the chunked TA replay (``rounds_per_step > 1``) belongs to the ``ta``
slice.

Every exact scan keeps a running top-K (the carry, sorted descending) and
folds one block of candidate scores into it per step. The fold is two
stage: a block-local top-k over the bare block scores, then a sorted merge
of two descending lists of k entries — never a selection over ``K + C``
lanes. Tie order is the reference's: within a block the lower position
wins, and in the merge the CARRY wins (its ids come from earlier blocks).
Both follow from one stable descending sort. Masking and placement use
``torch.where``, never a multiplication: values can be ``-inf`` and
``-inf * 0`` is NaN.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.core.naive import TopKResult, stable_topk

NEG_INF = float("-inf")

TA_SLICE = ("chunked TA rounds (ta_rounds=True, rounds_per_step > 1) come "
            "with the `ta` slice of the port (ROADMAP A1)")


def merge_topk_sorted(a_vals: torch.Tensor, a_ids: torch.Tensor,
                      b_vals: torch.Tensor, b_ids: torch.Tensor, k: int):
    """Top-``k`` of two DESCENDING-sorted (vals, ids) lists along the last
    axis (batched over any leading axes). Ties rank the ``a`` side first.
    """
    cand_vals = torch.cat([a_vals, b_vals], dim=-1)
    cand_ids = torch.cat([a_ids, b_ids], dim=-1)
    top, pos = stable_topk(cand_vals, k)
    return top, torch.gather(cand_ids, -1, pos)


def pad_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Pad sorted (vals, ids) along the last axis to k slots of (-inf, -1)."""
    kk = vals.shape[-1]
    if kk >= k:
        return vals, ids
    lead = tuple(vals.shape[:-1])
    vals = torch.cat([vals, torch.full(lead + (k - kk,), NEG_INF,
                                       dtype=vals.dtype, device=vals.device)],
                     dim=-1)
    ids = torch.cat([ids, torch.full(lead + (k - kk,), -1, dtype=ids.dtype,
                                     device=ids.device)], dim=-1)
    return vals, ids


def _block_topk(masked_scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Block-local top-k (sorted descending), padded to k slots. ``ids``
    is shared along the leading axes (``[C]``) or matches the scores."""
    kk = min(k, masked_scores.shape[-1])
    vals, pos = stable_topk(masked_scores, kk)
    bids = ids[pos] if ids.dim() == 1 else torch.gather(ids, -1, pos)
    return pad_topk(vals, bids, k)


def merge_block_into_carry_batched(top_vals, top_ids, masked_scores,
                                   rows, k):
    """Fold one block of ``[B, C]`` masked scores into every query's
    ``[B, K]`` carry. ``rows`` is the block's id vector, SHARED across the
    batch (``[C]``) or per query (``[B, C]``)."""
    bv, bi = _block_topk(masked_scores, rows.to(top_ids.dtype), k)
    return merge_topk_sorted(top_vals, top_ids, bv, bi, k)


@dataclasses.dataclass(frozen=True)
class BatchedScanStrategy:
    """A batch-NATIVE strategy: one shared enumeration for the whole batch.

    Attributes:
      block: ``step -> (ids, scores, fresh)`` — ``ids`` ``[C]`` (shared)
        or ``[B, C]`` (per query), ``scores`` ``[B, C]``, ``fresh``
        ``[B, C]`` bool: True where the slot is the FIRST enumeration of
        its item for that query and active.
      bound: ``step -> [B]`` bound on every item not yet enumerated.
      num_steps: blocks the enumeration covers.
      rounds_per_step: 1; chunked TA (> 1) raises ``NotImplementedError``.
    """

    block: Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    bound: Callable[[int], torch.Tensor]
    num_steps: int
    rounds_per_step: int = 1


class BatchedScanState(NamedTuple):
    step: int                  # blocks consumed by the batch-level loop
    steps: torch.Tensor        # [B] blocks each query consumed while live
    top_vals: torch.Tensor     # [B, K] running top scores, descending
    top_ids: torch.Tensor      # [B, K] their item ids
    n_scored: torch.Tensor     # [B] per-query score evaluations
    lower: torch.Tensor        # [B] running K-th best
    upper: torch.Tensor        # [B] bound on every unseen item


def initial_batched_state(B: int, k: int, dtype,
                          device) -> BatchedScanState:
    """Nothing scored: ``lower = -inf < upper = +inf`` in every lane."""
    return BatchedScanState(
        step=0,
        steps=torch.zeros((B,), dtype=torch.int32, device=device),
        top_vals=torch.full((B, k), NEG_INF, dtype=dtype, device=device),
        top_ids=torch.full((B, k), -1, dtype=torch.int32, device=device),
        n_scored=torch.zeros((B,), dtype=torch.int32, device=device),
        lower=torch.full((B,), NEG_INF, dtype=dtype, device=device),
        upper=torch.full((B,), float("inf"), dtype=dtype, device=device))


def batched_pruned_scan(U: torch.Tensor, strategy: BatchedScanStrategy,
                        k: int, dtype, max_steps: int = -1,
                        return_state: bool = False):
    """The batch-level pruned scan: ONE loop for the whole batch.

    The loop runs until every query has certified, so its step count is
    the deepest live query's; every per-query update is gated on that
    query's own ``lower < upper``, so ``n_scored`` and the per-query
    ``steps`` equal each query's sequential scan. ``depth`` of the result
    is per-query blocks. ``return_state=True`` also returns the final
    :class:`BatchedScanState`, whose ``steps`` is the absolute per-query
    cursor a chained tail resumes from, and whose ``step`` counts the
    loop's iterations (its host reads).
    """
    if strategy.rounds_per_step > 1:
        raise NotImplementedError(TA_SLICE)
    cap = strategy.num_steps if max_steps < 0 else min(max_steps,
                                                       strategy.num_steps)

    def body(s: BatchedScanState) -> BatchedScanState:
        live = s.lower < s.upper                              # [B]
        ids, scores, fresh = strategy.block(s.step)
        masked = torch.where(fresh, scores, NEG_INF)
        new_vals, new_ids = merge_block_into_carry_batched(
            s.top_vals, s.top_ids, masked, ids, k)
        gate = live[:, None]
        return BatchedScanState(
            step=s.step + 1,
            steps=torch.where(live, s.steps + 1, s.steps),
            top_vals=torch.where(gate, new_vals, s.top_vals),
            top_ids=torch.where(gate, new_ids, s.top_ids),
            n_scored=torch.where(
                live, s.n_scored + fresh.sum(1).to(torch.int32), s.n_scored),
            lower=torch.where(live, new_vals[:, k - 1], s.lower),
            upper=torch.where(live, strategy.bound(s.step), s.upper))

    s = initial_batched_state(U.shape[0], k, dtype, U.device)
    while s.step < cap:
        # block 0 is unconditionally live; later steps test the batch
        if s.step > 0 and not bool((s.lower < s.upper).any()):
            break
        s = body(s)
    # certificate tightening, per lane: a lane that consumed every block
    # has nothing un-enumerated (a budget halt keeps its block bound)
    upper = torch.where(s.steps >= strategy.num_steps, NEG_INF, s.upper)
    res = TopKResult(s.top_vals, s.top_ids, s.n_scored, s.steps, upper=upper)
    return (res, s) if return_state else res
