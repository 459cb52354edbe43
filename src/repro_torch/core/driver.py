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
host per step (one device-to-host synchronisation per block, as in the
``norm`` scan).

A chunked strategy (``rounds_per_step > 1``, the ``ta`` engine) makes one
step ``chunk`` sequential paper rounds: :func:`replay_rounds` recovers
them in closed form from the one scored block, so ``n_scored`` and the
depth in rounds equal the item-at-a-time algorithm's. The batched gather
tail (:mod:`repro_torch.core.blocked`) calls the same function on its
live lanes.

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

#: Elements one piece of lanes may hold in a per-lane temporary (64 MB of
#: int32): a batch's ``[B, C, R]`` freshness rank rows and its ``[B,
#: chunk, K + C]`` round-replay counts are taken a piece of lanes at a
#: time, never all at once.
KEY_PIECE_ELEMS = 1 << 24


def lane_pieces(n_lanes: int, elems_per_lane: int):
    """Slices of lanes whose temporaries fit :data:`KEY_PIECE_ELEMS`."""
    step = max(1, KEY_PIECE_ELEMS // max(int(elems_per_lane), 1))
    return [slice(i, i + step) for i in range(0, n_lanes, step)]


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


class RoundReplay(NamedTuple):
    """What :func:`replay_rounds` makes of one chunk, per lane."""
    top_vals: torch.Tensor     # [L, K] the carry after the processed rounds
    top_ids: torch.Tensor      # [L, K]
    n_scored: torch.Tensor     # [L] fresh candidates of the processed rounds
    processed: torch.Tensor    # [L] rounds the lane's sequential scan ran
    upper: torch.Tensor        # [L] Eq. 3 bound at the last processed round


def replay_rounds(top_vals, top_ids, upper, ids, scores, fresh, ubs,
                  base_round, round_cap: int, k: int) -> RoundReplay:
    """``chunk`` sequential paper rounds of ``L`` lanes from one scored
    block, in closed form (the reference's ``chunked_body``).

    The block's ``C = R * chunk`` slots are round-tagged row-major (slot
    ``r * chunk + j`` is list r's round j). Round j stops a lane's scan
    when its K-th best after rounds ``<= j`` reaches round j's Eq. 3 bound
    ``ubs[:, j]``, that is when at least k values of the carry and of the
    fresh candidates of rounds ``<= j`` reach it: a count over ``[L,
    chunk, K + C]``, taken a piece of lanes at a time. Candidates of the
    rounds after the stop are masked out of the merge and the count, so
    ``n_scored`` and the rounds processed equal the item-at-a-time
    algorithm's. ``base_round`` (``[L]``) is each lane's first round of
    the chunk; rounds from ``round_cap`` on (the budget, or the end of the
    catalogue) are never processed. ``upper`` is the lanes' bound before
    the chunk, kept by a lane that processes no round.

    Shapes: ``top_vals``/``top_ids`` ``[L, K]``, ``ids`` ``[C]`` or ``[L,
    C]``, ``scores``/``fresh`` ``[L, C]``, ``ubs`` ``[L, chunk]``.
    """
    L, C = scores.shape
    chunk = ubs.shape[1]
    dev = scores.device
    cap_local = torch.clamp(round_cap - base_round, 0, chunk)    # [L]
    tags = torch.arange(chunk, device=dev).repeat(C // chunk)    # [C]
    eligible = fresh & (tags[None, :] < cap_local[:, None])
    all_vals = torch.cat([top_vals, torch.where(eligible, scores, NEG_INF)],
                         dim=1)                                  # [L, K + C]
    all_tags = torch.cat([torch.full((k,), -1, dtype=tags.dtype,
                                     device=dev), tags])         # [K + C]
    js = torch.arange(chunk, device=dev)
    upto = all_tags[None, :] <= js[:, None]                      # [chunk, K+C]
    # row j counts what reaches round j's bound among rounds <= j and the
    # carry: lower_j >= ub_j  <=>  count >= k
    reach = torch.cat([
        ((all_vals[p, None, :] >= ubs[p, :, None]) & upto).sum(2)
        for p in lane_pieces(L, chunk * all_vals.shape[1])])     # [L, chunk]
    stop = (reach >= k) & (js[None, :] < cap_local[:, None])
    j_stop = stop.to(torch.int32).argmax(1)                      # first stop
    processed = torch.where(stop.any(1), j_stop + 1, cap_local)
    done = fresh & (tags[None, :] < processed[:, None])
    new_vals, new_ids = merge_block_into_carry_batched(
        top_vals, top_ids, torch.where(done, scores, NEG_INF), ids, k)
    last = ubs.gather(1, torch.clamp(processed - 1, min=0)[:, None])[:, 0]
    return RoundReplay(new_vals, new_ids, done.sum(1).to(torch.int32),
                       processed.to(torch.int32),
                       torch.where(processed > 0, last, upper))


@dataclasses.dataclass(frozen=True)
class BatchedScanStrategy:
    """A batch-NATIVE strategy: one shared enumeration for the whole batch.

    Attributes:
      block: ``step -> (ids, scores, fresh)`` — ``ids`` ``[C]`` (shared)
        or ``[B, C]`` (per query), ``scores`` ``[B, C]``, ``fresh``
        ``[B, C]`` bool: True where the slot is the FIRST enumeration of
        its item for that query and active.
      bound: ``step -> [B]`` bound on every item not yet enumerated;
        ``[B, rounds_per_step]``, one Eq. 3 bound per round, in chunked
        mode.
      num_steps: blocks the enumeration covers.
      rounds_per_step: > 1 makes a step that many sequential paper rounds
        (chunked TA, :func:`replay_rounds`); the candidates are then
        ``[R, rounds_per_step]`` flattened row-major, and the enumeration
        covers ``num_steps * rounds_per_step`` rounds. (The reference's
        ``num_rounds`` field exists only because its ``m_real`` padding
        can leave fewer; the port scans the real M.)
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
    rounds: torch.Tensor       # [B] per-query rounds (chunked mode)
    lower: torch.Tensor        # [B] running K-th best
    upper: torch.Tensor        # [B] bound on every unseen item


def initial_batched_state(B: int, k: int, dtype,
                          device) -> BatchedScanState:
    """Nothing scored: ``lower = -inf < upper = +inf`` in every lane."""
    zeros = torch.zeros((B,), dtype=torch.int32, device=device)
    return BatchedScanState(
        step=0, steps=zeros, rounds=zeros.clone(),
        top_vals=torch.full((B, k), NEG_INF, dtype=dtype, device=device),
        top_ids=torch.full((B, k), -1, dtype=torch.int32, device=device),
        n_scored=zeros.clone(),
        lower=torch.full((B,), NEG_INF, dtype=dtype, device=device),
        upper=torch.full((B,), float("inf"), dtype=dtype, device=device))


def batched_pruned_scan(U: torch.Tensor, strategy: BatchedScanStrategy,
                        k: int, dtype, max_steps: int = -1,
                        max_rounds: int = -1, return_state: bool = False):
    """The batch-level pruned scan: ONE loop for the whole batch.

    The loop runs until every query has certified, so its step count is
    the deepest live query's; every per-query update is gated on that
    query's own ``lower < upper``, so ``n_scored`` and the per-query
    ``steps`` (``rounds`` in chunked mode) equal each query's sequential
    scan. ``depth`` of the result is per-query blocks, or rounds in
    chunked mode, where ``max_rounds`` is the budget in rounds, held even
    in mid-step. ``return_state=True`` also returns the final
    :class:`BatchedScanState`, whose ``steps`` is the absolute per-query
    cursor a chained tail resumes from, and whose ``step`` counts the
    loop's iterations (its host reads).
    """
    chunk = strategy.rounds_per_step
    cap = strategy.num_steps if max_steps < 0 else min(max_steps,
                                                       strategy.num_steps)
    if chunk > 1:
        total_rounds = strategy.num_steps * chunk
        round_cap = (total_rounds if max_rounds < 0
                     else min(max_rounds, total_rounds))
        cap = min(cap, -(-round_cap // chunk))

    def body(s: BatchedScanState) -> BatchedScanState:
        live = s.lower < s.upper                              # [B]
        ids, scores, fresh = strategy.block(s.step)
        if chunk > 1:
            rep = replay_rounds(
                s.top_vals, s.top_ids, s.upper, ids, scores, fresh,
                strategy.bound(s.step),
                torch.full_like(s.rounds, s.step * chunk), round_cap, k)
            new_vals, new_ids, n_inc = rep.top_vals, rep.top_ids, rep.n_scored
            rounds = torch.where(live, s.rounds + rep.processed, s.rounds)
            upper_new = rep.upper
        else:
            new_vals, new_ids = merge_block_into_carry_batched(
                s.top_vals, s.top_ids, torch.where(fresh, scores, NEG_INF),
                ids, k)
            n_inc = fresh.sum(1).to(torch.int32)
            rounds = s.rounds
            upper_new = strategy.bound(s.step)
        gate = live[:, None]
        return BatchedScanState(
            step=s.step + 1,
            steps=torch.where(live, s.steps + 1, s.steps),
            top_vals=torch.where(gate, new_vals, s.top_vals),
            top_ids=torch.where(gate, new_ids, s.top_ids),
            n_scored=torch.where(live, s.n_scored + n_inc, s.n_scored),
            rounds=rounds,
            lower=torch.where(live, new_vals[:, k - 1], s.lower),
            upper=torch.where(live, upper_new, s.upper))

    s = initial_batched_state(U.shape[0], k, dtype, U.device)
    while s.step < cap:
        # block 0 is unconditionally live; later steps test the batch
        if s.step > 0 and not bool((s.lower < s.upper).any()):
            break
        s = body(s)
    # certificate tightening, per lane: a lane that consumed every block
    # (every round) has nothing un-enumerated (a budget halt keeps its
    # bound)
    if chunk > 1:
        depth, exhausted = s.rounds, s.rounds >= total_rounds
    else:
        depth, exhausted = s.steps, s.steps >= strategy.num_steps
    upper = torch.where(exhausted, NEG_INF, s.upper)
    res = TopKResult(s.top_vals, s.top_ids, s.n_scored, depth, upper=upper)
    return (res, s) if return_state else res
