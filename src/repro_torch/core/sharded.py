"""Exact top-K over a row-sharded catalogue: a device mesh, four sharded
strategies, and the mesh-free merge of shard-major score blocks.

The catalogue ``T`` is split by rows over one or more axes of a
:class:`Mesh` (DESIGN.md §5). The four strategies return the same set as
the unsharded algorithms, because the global top-K lies in the union of
the per-shard top-Ks:

1. :func:`sharded_naive_topk`: per-shard product and local top-k, then
   the ``P * K`` (value, global id) candidates merged.
2. :func:`sharded_blocked_topk`: per-shard BTA whose lower bound is the
   max of every shard's K-th best after each block (cross-shard
   tightening), so each shard prunes against the global K-th best. Its
   candidates are scored by kernel B4
   (:func:`repro_torch.kernels.gather_scores.gather_scores`).
3. :func:`hierarchical_merge_topk`: the merge in two levels, inside each
   group of the inner axes first, then across the outer axes.
4. :func:`sharded_norm_topk`: the batched norm scan per shard over a
   round-robin-dealt norm layout
   (:class:`repro_torch.core.layout.ShardedNormLayout`) with the same
   cross-shard tightening. It backs the ``norm_sharded`` engine.

**How the port runs a mesh.** One process drives every shard (the
reference is single-controller too: one ``TopKServer`` serves a mesh).
The mesh, the partition specs and :func:`repro_torch.core.mesh.shard_array`,
which deals an array over a mesh, live in :mod:`repro_torch.core.mesh`;
a device's shards are stacked ``[S, m_local, ...]`` so that one batched
op serves them all. All shards step in lockstep under
one Python loop: each ``pmax`` or ``any`` of the reference is a reduction
of the shards' ``[B]`` tensors on the first shard's device, read back as
one boolean a step; shards on other devices copy only those bounds and
their final ``[B, K]`` candidates. Each tiled ``all_gather`` followed by
``lax.top_k`` is a concatenation in the order the reference's gathers
produce (the last gathered axis outermost) and a STABLE top-k, so the
lower position wins ties.

:func:`shard_fold_topk` is the host-loop merge the LSM catalogue's L1
tier folds through (DESIGN.md §15): it needs no mesh.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.blocked import norm_scan_init, norm_scan_step
from repro_torch.core.driver import NEG_INF, merge_block_into_carry_batched
from repro_torch.core.mesh import (Mesh, ShardGroup, axis_sizes, gather_order,
                                   shard_array, spec_split)
from repro_torch.core.naive import TopKResult, stable_topk
from repro_torch.kernels.gather_scores import gather_scores


def shard_fold_topk(carry_vals: torch.Tensor, carry_ids: torch.Tensor,
                    scores: torch.Tensor, gids: torch.Tensor, k: int):
    """Fold ``S`` shard blocks into every query's ``[B, K]`` carry, one
    shard at a time, in shard order.

    ``scores [S, B, C]`` are one dense block per shard over the SAME query
    batch; ``gids [S, C]`` (or per-lane ``[S, B, C]``) carry global ids
    with ``-1`` marking dead or padding lanes (already ``-inf`` in
    ``scores``). Level 1 cuts each shard's block to ``K`` candidates (the
    block-local top-k of
    :func:`repro_torch.core.driver.merge_block_into_carry_batched`); level
    2 folds them through the O(K) sorted merge, the carry winning ties.
    Exact: the global top-K lies in the union of the per-shard top-Ks.
    """
    for s in range(scores.shape[0]):
        carry_vals, carry_ids = merge_block_into_carry_batched(
            carry_vals, carry_ids, scores[s], gids[s], k)
    return carry_vals, carry_ids


# ---------------------------------------------------------------------------
# Lockstep collectives over the shard groups
# ---------------------------------------------------------------------------


def _check_axes(spec, axes: Tuple[str, ...]) -> None:
    got = spec_split(spec)[1]
    if got != axes:
        raise ValueError(f"the spec splits rows over {got}, the strategy "
                         f"indexes shards over {axes}")


def _pmax(groups, per_group: List[torch.Tensor]) -> torch.Tensor:
    """Max over every shard of ``[S_g, B]`` tensors: ``[B]`` on the first
    shard's device."""
    lead = groups[0].device
    return torch.cat([t.to(lead) for t in per_group]).amax(0)


def _any(groups, per_group: List[torch.Tensor]) -> bool:
    """Whether any shard's flag holds: one host read."""
    lead = groups[0].device
    return bool(torch.stack([t.any().to(lead) for t in per_group]).any())


def _by_shard(groups, per_group: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-group ``[S_g, ...]`` stacks as one list indexed by shard, each
    on the first shard's device."""
    lead = groups[0].device
    out: List[Optional[torch.Tensor]] = [None] * sum(
        len(g.shards) for g in groups)
    for g, t in zip(groups, per_group):
        for j, s in enumerate(g.shards):
            out[s] = t[j].to(lead)
    return out


def _merge(vals: List[torch.Tensor], ids: List[torch.Tensor],
           order: Sequence[int], k: int):
    """Concatenate shards' ``[B, w]`` candidates in ``order`` and keep the
    stable top-``k`` (padded with ``(-inf, -1)`` when fewer)."""
    v = torch.cat([vals[s] for s in order], dim=1)
    i = torch.cat([ids[s] for s in order], dim=1)
    if v.shape[1] < k:
        b = v.shape[0]
        v = torch.cat([v, v.new_full((b, k - v.shape[1]), NEG_INF)], 1)
        i = torch.cat([i, i.new_full((b, k - i.shape[1]), -1)], 1)
    fv, pos = stable_topk(v, k)
    return fv, torch.gather(i, 1, pos)


def _sum_counts(groups, per_group: List[torch.Tensor]) -> torch.Tensor:
    """``psum`` of per-shard ``[S_g, B]`` counts: ``[B]`` int32."""
    lead = groups[0].device
    return torch.stack([t.sum(0).to(lead) for t in per_group]
                       ).sum(0).to(torch.int32)


def _local_topk(groups, parts, U, k):
    """Per shard ``T_l @ U`` and its stable top-``min(k, m_local)``:
    ``(vals, global ids)`` per group, ``[S_g, B, kk]``. The product runs
    in the promoted dtype of ``U`` and ``T`` (fp32 for a bf16 catalogue
    and fp32 queries, as the reference's ``preferred_element_type``)."""
    m_local = parts[0].shape[1]
    kk = min(k, m_local)
    dt = torch.promote_types(U.dtype, parts[0].dtype)
    vals, gids = [], []
    for g, T_g in zip(groups, parts):
        U_g = U.to(g.device, dt)
        scores = torch.matmul(U_g, T_g.to(dt).transpose(1, 2))  # [S_g, B, m]
        v, idx = stable_topk(scores, kk)
        shard = torch.tensor(g.shards, device=g.device)[:, None, None]
        vals.append(v)
        gids.append((idx + shard * m_local).to(torch.int32))
    return vals, gids


def _full_counts(groups, U, n_rows: int) -> Tuple[torch.Tensor, ...]:
    b = U.shape[0]
    lead = groups[0].device
    return (torch.full((b,), n_rows, dtype=torch.int32, device=lead),
            torch.zeros((b,), dtype=torch.int32, device=lead))


# ---------------------------------------------------------------------------
# The four strategies
# ---------------------------------------------------------------------------


def sharded_naive_topk(mesh: Mesh, T_spec, axis_names: Sequence[str]):
    """Exact sharded top-K: ``f(T, U, k) -> TopKResult``.

    Each shard scores its rows (``torch.matmul``; a device's shards in one
    batched product) and keeps its stable top-``min(k, m_local)``; the
    ``P * K`` candidates (values and global ids) are merged in the
    gathers' order. ``n_scored`` is ``M`` and ``depth`` 0. ``T`` is a
    tensor (dealt by ``T_spec`` at each call) or a :class:`repro_torch.core.mesh.ShardedArray`
    already dealt so.
    """
    axis_names = tuple(axis_names)
    _check_axes(T_spec, axis_names)
    order = gather_order(mesh, axis_names)

    def fn(T, U: torch.Tensor, k: int) -> TopKResult:
        T_sh = shard_array(T, mesh, T_spec)
        vals, gids = _local_topk(T_sh.groups, T_sh.parts, U, int(k))
        fv, fi = _merge(_by_shard(T_sh.groups, vals),
                        _by_shard(T_sh.groups, gids), order, int(k))
        return TopKResult(fv, fi, *_full_counts(T_sh.groups, U,
                                                T_sh.shape[0]))

    return fn


def hierarchical_merge_topk(mesh: Mesh, T_spec, inner_axes: Sequence[str],
                            outer_axes: Sequence[str]):
    """Two-level exact merge: the ``K`` candidates of each shard merge to
    ``K`` inside every group of the ``inner_axes`` (a pod), then only
    those ``K`` a pod are merged across the ``outer_axes``. The rows are
    split over ``outer_axes + inner_axes`` in that order. ``f(T, U, k)
    -> TopKResult``; ``n_scored`` is ``M`` and ``depth`` 0."""
    inner_axes, outer_axes = tuple(inner_axes), tuple(outer_axes)
    all_axes = outer_axes + inner_axes
    _check_axes(T_spec, all_axes)
    n_inner = math.prod(axis_sizes(mesh, inner_axes))
    inner_order = gather_order(mesh, inner_axes)
    outer_order = gather_order(mesh, outer_axes)

    def fn(T, U: torch.Tensor, k: int) -> TopKResult:
        k = int(k)
        T_sh = shard_array(T, mesh, T_spec)
        vals, gids = _local_topk(T_sh.groups, T_sh.parts, U, k)
        vals = _by_shard(T_sh.groups, vals)
        gids = _by_shard(T_sh.groups, gids)
        # level 1: inside each pod; level 2: only K a pod cross over
        pods = [_merge(vals, gids, [p * n_inner + i for i in inner_order],
                       k) for p in range(len(outer_order))]
        fv, fi = _merge([v for v, _ in pods], [i for _, i in pods],
                        outer_order, k)
        return TopKResult(fv, fi, *_full_counts(T_sh.groups, U,
                                                T_sh.shape[0]))

    return fn


def sharded_blocked_topk(mesh: Mesh, specs, axis_names: Sequence[str]):
    """Sharded BTA with cross-shard threshold tightening.

    ``specs`` are the partition specs of ``(T, order_desc,
    t_sorted_desc)``: the index arrays are split along their item axis
    (dimension 1) as ``T``'s rows, and each shard's lists hold LOCAL ids
    (an index built per slab). ``f(T, order_desc, t_sorted_desc, U, k,
    block_size=512) -> TopKResult``.

    Every step pops a depth block of ``block_size`` entries from all R
    lists of every shard (``R * block_size`` candidates a query, walked
    backwards where the query's weight is negative), scores the ones
    that are fresh (first in the block and not seen before) with kernel
    B4, one launch a device over all its shards' lanes (the plain
    version for CPU tensors), folds them into each query's carry and
    takes the Eq. 3 bound at the block's last depth. The lower bound is
    the max of every shard's K-th best. All queries and shards step
    until no shard has a query whose bound exceeds it, or the lists end;
    ``n_scored`` counts every step's fresh candidates over the shards and
    ``depth`` is ``steps * block_size``, as in the reference.
    """
    axis_names = tuple(axis_names)
    T_spec, order_spec, tsorted_spec = specs
    for spec in specs:
        _check_axes(spec, axis_names)
    order = gather_order(mesh, axis_names)

    def fn(T, order_desc, t_sorted_desc, U, k: int,
           block_size: int = 512) -> TopKResult:
        k = int(k)
        T_sh = shard_array(T, mesh, T_spec)
        od_sh = shard_array(order_desc, mesh, order_spec)
        ts_sh = shard_array(t_sorted_desc, mesh, tsorted_spec)
        groups = T_sh.groups
        m_local, R = T_sh.parts[0].shape[1:]
        B = U.shape[0]
        kk = min(k, m_local)
        n_blocks = -(-m_local // block_size)
        C = R * block_size
        runs = [_BlockedShards(g, T_g, od_g, ts_g, U, kk, block_size)
                for g, T_g, od_g, ts_g in zip(groups, T_sh.parts,
                                              od_sh.parts, ts_sh.parts)]
        b = 0
        while True:
            for run in runs:
                run.step(b, C)
            lower = _pmax(groups, [r.vals[..., kk - 1] for r in runs])
            b += 1
            if not (b < n_blocks and _any(groups, [
                    lower.to(r.dev)[None, :] < r.upper for r in runs])):
                break
        gids = []
        for r in runs:
            shard = torch.tensor(r.group.shards, device=r.dev)[:, None, None]
            gids.append(torch.where(r.ids >= 0, r.ids + shard * m_local,
                                    -1).to(torch.int32))
        fv, fi = _merge(_by_shard(groups, [r.vals for r in runs]),
                        _by_shard(groups, gids), order, k)
        n_scored = _sum_counts(groups, [r.n_scored for r in runs])
        depth = torch.full((B,), b * block_size, dtype=torch.int32,
                           device=n_scored.device)
        return TopKResult(fv, fi, n_scored, depth)

    return fn


class _BlockedShards:
    """The BTA state of one device's shards (``S_g`` of them): carries
    ``[S_g, B, kk]``, ``visited [S_g * B, m_local]``, per-shard counts and
    bounds ``[S_g, B]``."""

    def __init__(self, group: ShardGroup, T_g, od_g, ts_g, U, kk: int,
                 block_size: int):
        self.group, self.dev = group, group.device
        S, m_local, R = T_g.shape
        self.S, self.m_local, self.R = S, m_local, R
        self.kk, self.block_size = kk, block_size
        dev = self.dev
        self.U = U.to(dev)
        B = self.U.shape[0]
        self.T_flat = T_g.reshape(S * m_local, R)
        self.od_flat = od_g.reshape(S, R * m_local)
        self.ts_flat = ts_g.reshape(S, R * m_local)
        self.U_rep = self.U.repeat(S, 1).contiguous()           # [S*B, R]
        self.neg = self.U < 0
        self.list_base = torch.arange(R, device=dev) * m_local   # [R]
        self.slab_base = (torch.arange(S, device=dev, dtype=torch.int32)
                          * m_local)[:, None, None]
        self.vals = torch.full((S, B, kk), NEG_INF, dtype=T_g.dtype,
                               device=dev)
        self.ids = torch.full((S, B, kk), -1, dtype=torch.int32, device=dev)
        self.visited = torch.zeros((S * B, m_local), dtype=torch.bool,
                                   device=dev)
        self.n_scored = torch.zeros((S, B), dtype=torch.int32, device=dev)
        self.upper = torch.full((S, B), float("inf"), dtype=T_g.dtype,
                                device=dev)

    def step(self, b: int, C: int) -> None:
        S, m, R, blk, kk = (self.S, self.m_local, self.R, self.block_size,
                            self.kk)
        dev = self.dev
        B = self.U.shape[0]
        d0 = b * blk
        cols = torch.clamp(d0 + torch.arange(blk, device=dev), max=m - 1)
        cols_eff = torch.where(self.neg[:, :, None], m - 1 - cols,
                               cols)                             # [B, R, blk]
        flat = (self.list_base[None, :, None] + cols_eff).reshape(-1)
        cand = self.od_flat[:, flat].reshape(S, B, C)            # local ids
        rows = cand.reshape(S * B, C).long()
        # fresh: the first occurrence in the block of an id not visited
        # before (a visited id keeps -1, which no position equals)
        pos = torch.arange(C, dtype=torch.int32, device=dev)
        first = torch.full((S * B, m), C, dtype=torch.int32, device=dev)
        first.masked_fill_(self.visited, -1)
        first.scatter_reduce_(1, rows, pos.expand(S * B, C), "amin")
        fresh = first.gather(1, rows) == pos
        self.visited.scatter_(1, rows, True)
        scores = gather_scores(
            self.T_flat, (cand + self.slab_base).reshape(S * B, C),
            self.U_rep)                                          # kernel B4
        new_vals, new_ids = merge_block_into_carry_batched(
            self.vals.reshape(S * B, kk), self.ids.reshape(S * B, kk),
            torch.where(fresh, scores, NEG_INF), cand.reshape(S * B, C), kk)
        self.vals = new_vals.reshape(S, B, kk)
        self.ids = new_ids.reshape(S, B, kk)
        self.n_scored = self.n_scored + fresh.sum(1).to(
            torch.int32).reshape(S, B)
        end = min(d0 + blk - 1, m - 1)
        end_eff = torch.where(self.neg, m - 1 - end, end)        # [B, R]
        t_end = self.ts_flat[:, (self.list_base + end_eff).reshape(-1)]
        self.upper = (self.U[None] * t_end.reshape(S, B, R)).sum(-1)


def sharded_norm_topk(mesh: Mesh, axis_names: Sequence[str]):
    """Sharded shared-tile norm scan with cross-shard threshold tightening.

    The ``norm_sharded`` engine's scan: returns ``f(T_sh, norms_sh,
    ids_sh, U, k, block_size=256, max_blocks=-1) -> TopKResult`` over a
    :class:`repro_torch.core.layout.ShardedNormLayout`'s arrays
    (shard-major slabs of the round-robin-dealt norm order, split over
    ``axis_names``; id -1 marks padding, a suffix of each slab). Per
    shard the loop is the batched norm scan's step
    (:func:`repro_torch.core.blocked.norm_scan_step`: one ``[block, R]``
    tile, one product for the whole batch, a device's shards in one
    batched product); after every block the lower bound becomes the max
    of every shard's K-th best, so each shard prunes against the global
    K-th best.

    Kept from the reference: the first step runs when any shard has a
    real row (an all-padding shard steps along with live all-False); a
    shard stops at ``ceil(n_real / block)`` blocks; ``block = min(
    block_size, m_local)``; after block ``s`` the bound reads the norm at
    ``min((s+1)*block, m_local-1)``, a pad row's 0 at a slab's last real
    block; the merge pads to ``k`` when ``P * min(k, m_local) < k``.
    ``n_scored`` and ``depth`` are summed over shards, ``depth`` in rows
    (blocks * block). Exact: an item not yet enumerated on shard s is
    bounded by ``||u|| * next_local_norm(s)``, at most the global lower
    bound at that shard's stop.
    """
    axis_names = tuple(axis_names)
    row_spec = (axis_names,)
    order = gather_order(mesh, axis_names)

    def fn(T_sh, norms_sh, ids_sh, U, k: int, block_size: int = 256,
           max_blocks: int = -1) -> TopKResult:
        k = int(k)
        T_d = shard_array(T_sh, mesh, (axis_names, None))
        norms_d = shard_array(norms_sh, mesh, row_spec)
        ids_d = shard_array(ids_sh, mesh, row_spec)
        groups = T_d.groups
        m_local = T_d.parts[0].shape[1]
        B = U.shape[0]
        kk = min(k, m_local)
        blk = min(block_size, m_local)
        n_steps = -(-m_local // blk)
        cap = n_steps if max_blocks < 0 else min(max_blocks, n_steps)
        runs = [_NormShards(g, T_g, n_g, i_g, U, kk, blk, n_steps, cap)
                for g, T_g, n_g, i_g in zip(groups, T_d.parts, norms_d.parts,
                                            ids_d.parts)]
        lead = groups[0].device
        lower = torch.full((B,), NEG_INF, dtype=T_d.parts[0].dtype,
                           device=lead)
        step = 0
        active = _any(groups, [r.cap_rt > 0 for r in runs])
        while active:
            for r in runs:
                r.step(step, lower.to(r.dev))
            # the global K-th best >= the max of the local K-th bests: a
            # valid lower bound for every shard's pruning test
            lower = torch.maximum(lower, _pmax(
                groups, [r.st.top_vals[..., kk - 1] for r in runs]))
            active = _any(groups, [
                (step + 1 < r.cap_rt)
                & (lower.to(r.dev)[None, :] < r.st.upper).any(1)
                for r in runs])
            step += 1
        gids = [r.global_ids() for r in runs]
        fv, fi = _merge(_by_shard(groups, [r.st.top_vals for r in runs]),
                        _by_shard(groups, gids), order, k)
        n_scored = _sum_counts(groups, [r.st.n_scored for r in runs])
        depth = _sum_counts(groups, [r.st.depth for r in runs]) * blk
        return TopKResult(fv, fi, n_scored, depth)

    return fn


class _NormShards:
    """The norm-scan state of one device's shards: a
    :class:`repro_torch.core.blocked.NormScanState` with ``[S_g, B]``
    lead dimensions."""

    def __init__(self, group: ShardGroup, T_g, norms_g, ids_g, U, kk: int,
                 blk: int, n_steps: int, cap: int):
        self.group, self.dev = group, group.device
        dev = self.dev
        self.T, self.ids = T_g, ids_g
        self.S, self.m_local = T_g.shape[:2]
        self.U = U.to(dev)
        self.kk, self.blk = kk, blk
        # pad rows (id -1) are a slab suffix: cap each shard's loop at its
        # real rows, so a never-certified query stops where the unpadded
        # scan would
        n_real = (ids_g >= 0).sum(1)
        self.cap_rt = torch.clamp(-(-n_real // blk), max=cap)      # [S_g]
        next_starts = torch.clamp(
            (torch.arange(n_steps, device=dev) + 1) * blk,
            max=self.m_local - 1)
        self.bound_norms = norms_g[:, next_starts]         # [S_g, n_steps]
        self.u_norms = torch.linalg.norm(self.U, dim=1)    # [B]
        self.offs = torch.arange(blk, device=dev)
        self.st = norm_scan_init((self.S, self.U.shape[0]), kk, T_g.dtype,
                                 dev)

    def step(self, step: int, lower: torch.Tensor) -> None:
        blk, m = self.blk, self.m_local
        # per-query liveness, gated on THIS shard's real-row cap: the
        # lockstep loop runs while any shard is active, and a capped-out
        # shard must not count depth over its pad suffix
        live = (lower[None, :] < self.st.upper) & (step < self.cap_rt)[:, None]
        d0 = step * blk
        start = max(0, min(d0, m - blk))
        tile = self.T[:, start:start + blk]                  # [S_g, blk, R]
        # one shard: the single-host scan's own product, bit for bit
        scores = ((self.U @ tile[0].T)[None] if self.S == 1
                  else torch.matmul(self.U, tile.transpose(1, 2)))
        rows = start + self.offs
        # the tail block slides back (mask re-read rows) and pad rows
        valid = (rows >= d0)[None, :] & (self.ids[:, start:start + blk] >= 0)
        self.st = norm_scan_step(
            self.st, scores, rows.to(torch.int32), valid, live,
            self.u_norms[None, :] * self.bound_norms[:, step, None], self.kk)

    def global_ids(self) -> torch.Tensor:
        """Local rows -> GLOBAL catalogue ids (-1 kept)."""
        ti = self.st.top_ids
        safe = torch.clamp(ti, 0, self.m_local - 1).long()
        gid = torch.gather(self.ids, 1, safe.reshape(self.S, -1)
                           ).reshape(ti.shape)
        return torch.where(ti >= 0, gid, -1).to(torch.int32)

