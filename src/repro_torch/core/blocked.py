"""The Block Threshold Algorithm (BTA) and the norm-ordered block scan.

**BTA** restructures the paper's Threshold Algorithm around dense work:
one step pops a depth block of ``block_size`` entries from all R sorted
lists (``R * block_size`` candidates), scores the fresh ones, folds them
into the running top-K, and evaluates the Eq. 3 stopping bound at the
block's LAST depth — still a valid bound for every unseen item because
the lists are monotone, so the result is exact. ``block_size=1``
recovers TA's rounds (:func:`repro_torch.core.threshold.threshold_topk_np`
is the item-at-a-time oracle).

With the ``list_major`` layout a scan runs in two phases: the contiguous
list PREFIX (tile slices, no gathers; for a batch, one shared tile per
step), then, for a query that outlives the prefix, the gather-side TAIL,
which resumes at the query's own absolute block cursor. The tail scores
its candidates with kernel B4
(:func:`repro_torch.kernels.gather_scores.gather_scores`): on a CUDA
tensor the kernel is the only tail scorer there is. The batched tail is
one loop over the lanes still live, each at its own cursor, gated on its
own bound and step cap; its results and ``n_scored``/``depth``/``upper``
equal the reference's vmapped per-lane tail lane for lane.

**Chunked TA** (the ``ta`` engine, :func:`chunked_ta_topk*`) runs the
same two phases with ``chunk`` depths a step, each its own paper round:
the driver's :func:`repro_torch.core.driver.replay_rounds` recovers the
sequential rounds from each scored block, in the prefix and in the tail
alike, so ``n_scored`` and ``depth`` (in rounds) equal the item-at-a-time
algorithm's while the work stays block-shaped.

The loops read one boolean back to the host per step (``any lane
live``); callers may pass a :class:`collections.Counter` as ``steps`` to
count them (``"prefix"``, ``"tail"`` and ``"gather"`` iterations).

**The norm scan** walks the catalogue in decreasing-norm order, one
contiguous ``[block, R]`` tile per step. After block ``b`` every unseen
score is bounded by ``||u|| * norms_sorted[(b+1)*block]``; a query stops
as soon as its running K-th best reaches that bound. Its continuation
test is the same one-boolean host read per block.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import torch

from repro_torch.core.driver import (BatchedScanState, NEG_INF,
                                     batched_pruned_scan,
                                     initial_batched_state,
                                     merge_block_into_carry_batched,
                                     replay_rounds)
from repro_torch.core.index import TopKIndex
from repro_torch.core.naive import TopKResult
from repro_torch.core.strategies import (batched_list_prefix_strategy,
                                         rank_gather_first_keys,
                                         sign_bucket)
from repro_torch.kernels.gather_scores import gather_scores


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _count(steps: Optional[collections.Counter], key: str, n: int) -> None:
    if steps is not None:
        steps[key] += n


def _batched_list_tail(targets, order_desc, t_sorted_desc, rank_by_item, U,
                       k, block_size, max_blocks, state: BatchedScanState,
                       ta_rounds: bool = False, max_rounds: int = -1):
    """The gather-side list scan of a batch, resumed from ``state``: ONE
    loop whose every step serves the lanes still live.

    Lane ``b`` resumes at its own absolute block cursor ``state.steps[b]``
    and takes a step while ``cursor < cap`` and ``lower < upper`` hold for
    it. A step pops a depth block of ``block_size`` entries from all R
    lists: its candidates are ``order_desc`` at the block's depths with
    the lane's own per-list direction flip (depth ``d`` of list ``r``
    reads position ``M-1-d`` when ``u_r < 0``; ``[L, R*block]``), their
    freshness comes from :func:`rank_gather_first_keys`, one B4 launch
    scores the ``[L, C]`` ids of all ``L`` live lanes against their
    queries, and the Eq. 3 bound is taken at the block's last depth,
    still valid for every unseen item because the lists are monotone.
    Only the live lanes are gathered.

    ``ta_rounds`` with ``block_size > 1`` is chunked TA: a step takes the
    live lanes' Eq. 3 bounds at every depth of the block and replays its
    ``block_size`` rounds (:func:`repro_torch.core.driver.replay_rounds`,
    the prefix driver's own), each lane from its own cursor; ``max_rounds``
    is the budget in rounds. Returns the result (``depth`` in list-depth
    rows, which are rounds in chunked mode) and the loop's iteration
    count.
    """
    R, M = order_desc.shape
    dev = U.device
    chunked = ta_rounds and block_size > 1
    n_steps = _cdiv(M, block_size)
    cap = n_steps if max_blocks < 0 else min(max_blocks, n_steps)
    round_cap = M if max_rounds < 0 else min(max_rounds, M)
    if chunked:
        cap = min(cap, _cdiv(round_cap, block_size))
    C = R * block_size
    neg = U < 0
    active_rep = (U != 0).repeat_interleave(block_size, dim=1)    # [B, C]
    offs = torch.arange(block_size, device=dev)
    slot_r = torch.arange(R, device=dev).repeat_interleave(block_size)
    slot_depth = offs.repeat(R)                                    # [C]
    list_base = torch.arange(R, device=dev) * M                    # [R]
    od_flat = order_desc.reshape(-1)
    t_flat = t_sorted_desc.reshape(-1)
    cursor = state.steps.clone()
    top_vals, top_ids = state.top_vals.clone(), state.top_ids.clone()
    n_scored, rounds = state.n_scored.clone(), state.rounds.clone()
    lower, upper = state.lower.clone(), state.upper.clone()
    iters = 0
    while True:
        lanes = ((cursor < cap) & (lower < upper)).nonzero().squeeze(1)
        if lanes.numel() == 0:          # the step's one host read
            break
        iters += 1
        u = U[lanes]                                               # [L, R]
        lneg = neg[lanes]
        d0 = cursor[lanes].long() * block_size                     # [L]
        cols = torch.clamp(d0[:, None] + offs, max=M - 1)          # [L, Bk]
        cols_eff = torch.where(lneg[:, :, None], M - 1 - cols[:, None, :],
                               cols[:, None, :])                   # [L, R, Bk]
        ids = od_flat[list_base[None, :, None] + cols_eff].reshape(-1, C)
        scores = gather_scores(targets, ids, u)                    # [L, C]
        d = d0[:, None] + slot_depth                 # unclamped true depth
        fresh = (active_rep[lanes]
                 & (rank_gather_first_keys(rank_by_item, u, ids)
                    == d * R + slot_r) & (d < M))
        if chunked:
            # Eq. 3 at every depth of the block (the same clamped columns)
            t_at = t_flat[list_base[None, :, None] + cols_eff]     # [L, R, Bk]
            rep = replay_rounds(
                top_vals[lanes], top_ids[lanes], upper[lanes], ids, scores,
                fresh, (u[:, :, None] * t_at).sum(1), d0, round_cap, k)
            new_vals, new_ids, bound = rep.top_vals, rep.top_ids, rep.upper
            n_scored[lanes] += rep.n_scored
            rounds[lanes] += rep.processed
        else:
            new_vals, new_ids = merge_block_into_carry_batched(
                top_vals[lanes], top_ids[lanes],
                torch.where(fresh, scores, NEG_INF), ids, k)
            end = torch.clamp(d0 + block_size - 1, max=M - 1)      # [L]
            end_eff = torch.where(lneg, M - 1 - end[:, None], end[:, None])
            bound = torch.sum(u * t_flat[list_base + end_eff], dim=1)
            n_scored[lanes] += fresh.sum(1).to(torch.int32)
        top_vals[lanes] = new_vals
        top_ids[lanes] = new_ids
        cursor[lanes] += 1
        lower[lanes] = new_vals[:, k - 1]
        upper[lanes] = bound
    # certificate tightening, per lane: every block (every round)
    # consumed -> -inf
    if chunked:
        depth, exhausted = rounds, rounds >= M
    else:
        depth, exhausted = cursor * block_size, cursor >= n_steps
    upper = torch.where(exhausted, NEG_INF, upper)
    return TopKResult(top_vals, top_ids, n_scored, depth, upper=upper), iters


def _batched_two_phase_list_scan(targets, order_desc, t_sorted_desc, U, k,
                                 block_size, max_blocks, layout, sign, dense,
                                 steps=None, ta_rounds: bool = False,
                                 max_rounds: int = -1) -> TopKResult:
    """Batch-native prefix phase chained into the batched gather tail.

    Phase 1 is :func:`repro_torch.core.driver.batched_pruned_scan` over
    :func:`repro_torch.core.strategies.batched_list_prefix_strategy`; its
    final state (per-lane absolute cursors in ``steps``, rounds in
    ``rounds``) seeds :func:`_batched_list_tail`. A batch whose every
    query certified inside the prefix runs no tail step. ``depth`` is in
    list-depth rows (rounds).
    """
    prefix = batched_list_prefix_strategy(layout, t_sorted_desc, U,
                                          block_size, sign=sign, dense=dense,
                                          ta_rounds=ta_rounds)
    _, bstate = batched_pruned_scan(U, prefix, k, targets.dtype,
                                    max_steps=max_blocks,
                                    max_rounds=max_rounds, return_state=True)
    res, iters = _batched_list_tail(targets, order_desc, t_sorted_desc,
                                    layout.rank_by_item, U, k, block_size,
                                    max_blocks, bstate, ta_rounds=ta_rounds,
                                    max_rounds=max_rounds)
    _count(steps, "prefix", bstate.step)
    _count(steps, "tail", iters)
    return res


def _check_native(name, layout, block_size, sign):
    if layout is None or layout.prefix_steps(block_size) < 1:
        raise ValueError(f"{name} requires a ListMajorLayout with >= 1 "
                         "prefix block")
    if not layout.serves_sign(sign):
        raise ValueError(
            f"layout with sides {layout.sides!r} cannot serve sign "
            f"bucket {sign} (mixed batches need both directions)")


def blocked_topk_batched_native(
    targets: torch.Tensor,
    order_desc: torch.Tensor,
    t_sorted_desc: torch.Tensor,
    U: torch.Tensor,
    k: int,
    block_size: int = 256,
    max_blocks: int = -1,
    layout=None,
    sign: int = 0,
    dense: bool = False,
    steps: Optional[collections.Counter] = None,
) -> TopKResult:
    """Batch-native BTA over the list-prefix layout.

    One shared prefix tile per step for the whole batch, per-query
    freshness and liveness, then the batched gather tail, so results AND
    ``n_scored``/``depth``/``upper`` equal each query's own
    :func:`blocked_topk`. ``sign``/``dense`` are the batch's sign bucket
    (:func:`repro_torch.core.strategies.sign_bucket`); the caller
    guarantees they match ``U`` and that ``layout`` has the needed
    side(s). ``depth`` is in list-depth rows.
    """
    _check_native("blocked_topk_batched_native", layout, block_size, sign)
    k = min(int(k), targets.shape[0])
    return _batched_two_phase_list_scan(
        targets, order_desc, t_sorted_desc, U, k, block_size, max_blocks,
        layout, sign, dense, steps=steps)


def _gather_topk(targets, order_desc, t_sorted_desc, rank_by_item, U, k,
                 block_size, max_blocks, steps, ta_rounds: bool = False,
                 max_rounds: int = -1) -> TopKResult:
    """The gather path: the batched gather loop from step 0 (``depth`` in
    list-depth rows, which are rounds for chunked TA)."""
    k = min(int(k), targets.shape[0])
    state = initial_batched_state(U.shape[0], k, targets.dtype, U.device)
    res, iters = _batched_list_tail(targets, order_desc, t_sorted_desc,
                                    rank_by_item, U, k, block_size,
                                    max_blocks, state, ta_rounds=ta_rounds,
                                    max_rounds=max_rounds)
    _count(steps, "gather", iters)
    return res


def _rank_by_item(order_desc: torch.Tensor) -> torch.Tensor:
    """``[M, R]`` position of every item in every list: the inverse
    permutations of ``order_desc``, transposed."""
    R, M = order_desc.shape
    pos = torch.arange(M, dtype=torch.int32, device=order_desc.device)
    return torch.empty((M, R), dtype=torch.int32,
                       device=order_desc.device).scatter_(
        0, order_desc.T.long(), pos[:, None].expand(M, R))


def blocked_topk(
    targets: torch.Tensor,
    order_desc: torch.Tensor,
    t_sorted_desc: torch.Tensor,
    u: torch.Tensor,
    k: int,
    block_size: int = 256,
    max_blocks: int = -1,
    rank_desc: Optional[torch.Tensor] = None,
    layout=None,
) -> TopKResult:
    """Exact top-K of one query ``u: [R]`` by the Block Threshold
    Algorithm: the batch of one of the batched drivers.

    ``layout`` (a :class:`repro_torch.core.layout.ListMajorLayout` that
    serves the query's sign) scores the blocks inside its prefix from
    contiguous tiles and gathers only past it
    (:func:`blocked_topk_batched_native`); without it every block is
    gathered, with freshness from ``rank_desc`` (the index's inverse
    permutations, worked out from ``order_desc`` when absent). All give
    identical results and counts. ``max_blocks`` is the halted variant's
    block budget; ``depth`` is in list-depth rows.
    """
    U = u[None, :]
    if layout is not None and layout.prefix_steps(block_size) > 0:
        sign, dense = sign_bucket(U)
        res = blocked_topk_batched_native(
            targets, order_desc, t_sorted_desc, U, k, block_size,
            max_blocks, layout=layout, sign=sign, dense=dense)
    else:
        rank_by_item = (_rank_by_item(order_desc) if rank_desc is None
                        else rank_desc.T)
        res = _gather_topk(targets, order_desc, t_sorted_desc, rank_by_item,
                           U, k, block_size, max_blocks, None)
    return TopKResult(*(x[0] for x in res))


def blocked_topk_batched(
    targets: torch.Tensor,
    index: TopKIndex,
    U: torch.Tensor,
    k: int,
    block_size: int = 256,
    max_blocks: int = -1,
    steps: Optional[collections.Counter] = None,
) -> TopKResult:
    """BTA over a query batch ``U: [B, R]`` by the gather path (no list
    layout): the batched gather loop from step 0, freshness from the
    index's ``rank_desc`` read per candidate. Each query's result and
    counts equal its own :func:`blocked_topk`, as the reference's vmap of
    it does."""
    return _gather_topk(targets, index.order_desc, index.t_sorted_desc,
                        index.rank_desc.T, U, k, block_size, max_blocks,
                        steps)


# ---------------------------------------------------------------------------
# Chunked TA: block-shaped steps, item-at-a-time accounting
# ---------------------------------------------------------------------------


def chunked_ta_topk_batched_native(
    targets: torch.Tensor,
    order_desc: torch.Tensor,
    t_sorted_desc: torch.Tensor,
    U: torch.Tensor,
    k: int,
    chunk: int = 32,
    max_rounds: int = -1,
    layout=None,
    sign: int = 0,
    dense: bool = False,
    steps: Optional[collections.Counter] = None,
) -> TopKResult:
    """Batch-native chunked TA over the list-prefix layout.

    The shared prefix tiles feed the driver's replay of each chunk's
    sequential rounds, lane by lane, and the batched gather tail replays
    its chunks with the same function, so each query's ``n_scored`` and
    ``depth`` (in rounds) equal the item-at-a-time algorithm's
    (:func:`repro_torch.core.threshold.threshold_topk_np`).
    ``sign``/``dense`` are the batch's sign bucket, as in
    :func:`blocked_topk_batched_native`. ``max_rounds`` is the halted
    TA's budget, held at round granularity even in mid-chunk; at
    ``chunk == 1`` a step is one round and the budget caps the steps.
    """
    _check_native("chunked_ta_topk_batched_native", layout, chunk, sign)
    k = min(int(k), targets.shape[0])
    return _batched_two_phase_list_scan(
        targets, order_desc, t_sorted_desc, U, k, chunk,
        max_rounds if chunk == 1 else -1, layout, sign, dense, steps=steps,
        ta_rounds=chunk > 1, max_rounds=max_rounds)


def _chunked_ta_gather(targets, order_desc, t_sorted_desc, rank_by_item, U,
                       k, chunk, max_rounds, steps) -> TopKResult:
    """Chunked TA by the gather path, from round 0; at ``chunk == 1`` the
    plain single-round blocks, the budget capping the steps."""
    return _gather_topk(targets, order_desc, t_sorted_desc, rank_by_item, U,
                        k, chunk, max_rounds if chunk == 1 else -1, steps,
                        ta_rounds=chunk > 1, max_rounds=max_rounds)


def chunked_ta_topk(
    targets: torch.Tensor,
    order_desc: torch.Tensor,
    t_sorted_desc: torch.Tensor,
    rank_desc: Optional[torch.Tensor],
    u: torch.Tensor,
    k: int,
    chunk: int = 32,
    max_rounds: int = -1,
    layout=None,
) -> TopKResult:
    """Exact TA of one query ``u: [R]`` whose rounds are processed
    ``chunk`` at a time: the batch of one of the batched drivers.

    One step gathers and scores ``R * chunk`` candidates, then replays the
    chunk as ``chunk`` sequential paper rounds, so ``n_scored`` and
    ``depth`` (in rounds) equal the ``chunk = 1`` algorithm's and
    :func:`repro_torch.core.threshold.threshold_topk_np`'s. ``max_rounds``
    is the halted TA's budget, held even in mid-chunk. ``layout`` (serving
    the query's sign) makes the rounds inside its prefix gather-free
    (:func:`chunked_ta_topk_batched_native`); without it every chunk is
    gathered, with freshness from ``rank_desc`` (worked out from
    ``order_desc`` when absent).
    """
    U = u[None, :]
    if layout is not None and chunk > 1 and layout.prefix_steps(chunk) > 0:
        sign, dense = sign_bucket(U)
        res = chunked_ta_topk_batched_native(
            targets, order_desc, t_sorted_desc, U, k, chunk, max_rounds,
            layout=layout, sign=sign, dense=dense)
    else:
        rank_by_item = (_rank_by_item(order_desc) if rank_desc is None
                        else rank_desc.T)
        res = _chunked_ta_gather(targets, order_desc, t_sorted_desc,
                                 rank_by_item, U, k, chunk, max_rounds, None)
    return TopKResult(*(x[0] for x in res))


def chunked_ta_topk_batched(
    targets: torch.Tensor,
    index: TopKIndex,
    U: torch.Tensor,
    k: int,
    chunk: int = 32,
    max_rounds: int = -1,
    steps: Optional[collections.Counter] = None,
) -> TopKResult:
    """Chunked TA over a query batch ``U: [B, R]`` by the gather path (no
    list layout), freshness from the index's ``rank_desc``: each query's
    result and counts equal its own :func:`chunked_ta_topk`, as the
    reference's vmap of it does."""
    return _chunked_ta_gather(targets, index.order_desc, index.t_sorted_desc,
                              index.rank_desc.T, U, k, chunk, max_rounds,
                              steps)


class NormScanState(NamedTuple):
    """The norm scan's per-lane state; any lead dimensions (``[B]`` for
    the single-host scan, ``[S, B]`` for a device's shards)."""
    top_vals: torch.Tensor   # [..., K] the carry, descending
    top_ids: torch.Tensor    # [..., K] int32 norm-order rows
    n_scored: torch.Tensor   # [...] int32 rows scored
    depth: torch.Tensor      # [...] int32 blocks taken
    upper: torch.Tensor      # [...] bound on every row not yet taken


def norm_scan_init(lead: tuple, k: int, dtype, device) -> NormScanState:
    """Empty carries, zero counts and an infinite bound."""
    return NormScanState(
        torch.full(lead + (k,), float("-inf"), dtype=dtype, device=device),
        torch.full(lead + (k,), -1, dtype=torch.int32, device=device),
        torch.zeros(lead, dtype=torch.int32, device=device),
        torch.zeros(lead, dtype=torch.int32, device=device),
        torch.full(lead, float("inf"), dtype=dtype, device=device))


def norm_scan_step(st: NormScanState, scores, rows, valid, live, bound,
                   k: int) -> NormScanState:
    """One block of the norm scan for every ``live`` lane: fold the
    tile's ``scores [..., B, block]`` (``valid [..., block]`` masks rows
    re-read by a tail block that slid back, and pad rows; ``rows
    [block]`` are their norm-order positions) into the carry, count the
    valid rows and the block, and take ``bound`` (the norm bound after
    the block) as the lane's upper bound. A lane that is not live keeps
    its state. The single-host scan and the sharded scan
    (:func:`repro_torch.core.sharded.sharded_norm_topk`) share it; each
    keeps its own lower bound and loop."""
    masked = torch.where(valid[..., None, :], scores, NEG_INF)
    new_vals, new_ids = merge_block_into_carry_batched(
        st.top_vals, st.top_ids, masked, rows, k)
    fresh = valid.sum(-1, keepdim=True).to(torch.int32)
    gate = live[..., None]
    return NormScanState(
        torch.where(gate, new_vals, st.top_vals),
        torch.where(gate, new_ids, st.top_ids),
        torch.where(live, st.n_scored + fresh, st.n_scored),
        torch.where(live, st.depth + 1, st.depth),
        torch.where(live, bound, st.upper))


def norm_pruned_topk_batched(
    targets_by_norm: torch.Tensor,
    norm_order: torch.Tensor,
    norms_sorted: torch.Tensor,
    U: torch.Tensor,
    k: int,
    block_size: int = 256,
    max_blocks: int = -1,
    m_real: Optional[int] = None,
) -> TopKResult:
    """Batched norm scan: ONE shared tile per step for the whole batch.

    Each step slices one contiguous tile of the norm-ordered catalogue and
    scores the batch with one ``[B, R] @ [R, block]`` matmul
    (:func:`norm_scan_step`). Per-query liveness gates every state update,
    so each query's ``n_scored`` and ``depth`` equal its own sequential
    scan's; the loop runs until the slowest live query certifies (or
    ``max_blocks`` halts it).

    ``m_real`` is the real catalogue size when the norm arrays are padded
    to an M-bucket (pad rows zero, norm 0, id -1, sorted last): the tail
    block slides back against the real end, pad rows are masked from the
    merge and the counters, and the step cap stops where the unpadded scan
    stops. Returns catalogue ids (rows are remapped through
    ``norm_order`` once, after the loop) and ``depth`` in rows.
    """
    M, R = targets_by_norm.shape
    if block_size > M:
        raise ValueError(f"block_size {block_size} exceeds the {M} "
                         "catalogue rows; pass min(block_size, M)")
    m = M if m_real is None else int(m_real)
    B = U.shape[0]
    k = min(int(k), M)
    dev, dt = targets_by_norm.device, targets_by_norm.dtype
    n_steps = _cdiv(M, block_size)
    cap = n_steps if max_blocks < 0 else min(max_blocks, n_steps)
    cap_eff = cap if m_real is None else min(cap, _cdiv(m, block_size))
    next_starts = torch.clamp(
        (torch.arange(n_steps, device=dev) + 1) * block_size, max=m - 1)
    bound_norms = norms_sorted[next_starts]              # [n_steps]
    u_norms = torch.linalg.norm(U, dim=1)                # [B]
    offs = torch.arange(block_size, device=dev)

    st = norm_scan_init((B,), k, dt, dev)
    lower = torch.full((B,), float("-inf"), dtype=dt, device=dev)
    step = 0
    while step < cap:
        # block 0 is unconditionally live (lower = -inf < upper = +inf);
        # every later step tests the caps and the batch's liveness first
        if step > 0 and not (step < cap_eff
                             and bool(torch.any(lower < st.upper))):
            break
        live = lower < st.upper                          # [B]
        d0 = step * block_size
        start = max(0, min(d0, m - block_size))
        tile = targets_by_norm[start:start + block_size]  # [block, R]
        scores = U @ tile.T                              # [B, block]
        rows = start + offs
        # the tail block slides back (mask re-read rows); pad rows masked
        valid = (rows >= d0) & (rows < m)
        st = norm_scan_step(st, scores, rows.to(torch.int32), valid, live,
                            u_norms * bound_norms[step], k)
        lower = torch.where(live, st.top_vals[:, k - 1], lower)
        step += 1

    safe = torch.clamp(st.top_ids, 0, M - 1).long()
    ids = torch.where(st.top_ids >= 0, norm_order[safe],
                      torch.full_like(st.top_ids, -1))
    # certificate tightening: a lane that consumed every REAL block has
    # nothing un-enumerated — vacuous -inf bound; only a budget halt keeps
    # the live block bound
    full_steps = _cdiv(m, block_size)
    upper = torch.where(st.depth >= full_steps, NEG_INF, st.upper)
    return TopKResult(st.top_vals, ids.to(torch.int32), st.n_scored,
                      st.depth * block_size, upper=upper)


def norm_pruned_topk(
    targets: torch.Tensor,
    norm_order: torch.Tensor,
    norms_sorted: torch.Tensor,
    u: torch.Tensor,
    k: int,
    block_size: int = 256,
    max_blocks: int = -1,
    targets_by_norm: Optional[torch.Tensor] = None,
    m_real: Optional[int] = None,
) -> TopKResult:
    """Exact top-K of one query ``u: [R]``, scanning blocks in
    decreasing-norm order (the B = 1 case of the batched scan).

    ``targets_by_norm`` is the catalogue already permuted into norm order
    (gathered from ``targets`` when absent). A catalogue shorter than one
    block is zero-padded to a full block and scanned with ``m_real``, so
    ``depth`` still counts whole blocks, as in the reference.
    """
    if targets_by_norm is None:
        targets_by_norm = targets[norm_order.long()]
    m_tot = targets.shape[0]
    k = min(int(k), m_tot)
    if m_tot < block_size:
        m_real = m_tot if m_real is None else m_real
        pad = block_size - m_tot
        targets_by_norm = torch.cat([targets_by_norm, targets_by_norm.new_zeros(
            (pad, targets_by_norm.shape[1]))])
        norm_order = torch.cat([norm_order, norm_order.new_full((pad,), -1)])
        norms_sorted = torch.cat([norms_sorted, norms_sorted.new_zeros(pad)])
    res = norm_pruned_topk_batched(targets_by_norm, norm_order, norms_sorted,
                                   u[None, :], k, block_size, max_blocks,
                                   m_real=m_real)
    return TopKResult(*(x[0] for x in res))
