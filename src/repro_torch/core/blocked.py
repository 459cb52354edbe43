"""Norm-ordered Cauchy-Schwarz block pruning (beyond the paper; exact).

The catalogue is scanned in decreasing-norm order, one contiguous
``[block, R]`` tile per step. After block ``b`` every unseen score is
bounded by ``||u|| * norms_sorted[(b+1)*block]``; a query stops as soon as
its running K-th best reaches that bound.

The reference runs the scan as one ``lax.while_loop``; here it is a
Python loop over device tensors. Its continuation test
``any(lower < upper)`` reads one boolean back to the host per step — one
device-to-host synchronisation per block, accepted in this slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.driver import merge_block_into_carry_batched
from repro_torch.core.naive import TopKResult


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    scores the batch with one ``[B, R] @ [R, block]`` matmul. Per-query
    liveness gates every state update, so each query's ``n_scored`` and
    ``depth`` equal its own sequential scan's; the loop runs until the
    slowest live query certifies (or ``max_blocks`` halts it).

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
    neg_inf = torch.tensor(float("-inf"), dtype=dt, device=dev)

    top_vals = torch.full((B, k), float("-inf"), dtype=dt, device=dev)
    top_ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    n_scored = torch.zeros((B,), dtype=torch.int32, device=dev)
    depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    lower = torch.full((B,), float("-inf"), dtype=dt, device=dev)
    upper = torch.full((B,), float("inf"), dtype=dt, device=dev)

    step = 0
    while step < cap:
        # block 0 is unconditionally live (lower = -inf < upper = +inf);
        # every later step tests the caps and the batch's liveness first
        if step > 0 and not (step < cap_eff
                             and bool(torch.any(lower < upper))):
            break
        live = lower < upper                             # [B]
        d0 = step * block_size
        start = max(0, min(d0, m - block_size))
        tile = targets_by_norm[start:start + block_size]  # [block, R]
        scores = U @ tile.T                              # [B, block]
        rows = start + offs
        # the tail block slides back (mask re-read rows); pad rows masked
        valid = (rows >= d0) & (rows < m)
        masked = torch.where(valid[None, :], scores, neg_inf)
        new_vals, new_ids = merge_block_into_carry_batched(
            top_vals, top_ids, masked, rows.to(torch.int32), k)
        fresh = valid.sum().to(torch.int32)
        gate = live[:, None]
        top_vals = torch.where(gate, new_vals, top_vals)
        top_ids = torch.where(gate, new_ids, top_ids)
        n_scored = torch.where(live, n_scored + fresh, n_scored)
        depth = torch.where(live, depth + 1, depth)
        lower = torch.where(live, new_vals[:, k - 1], lower)
        upper = torch.where(live, u_norms * bound_norms[step], upper)
        step += 1

    safe = torch.clamp(top_ids, 0, M - 1).long()
    ids = torch.where(top_ids >= 0, norm_order[safe],
                      torch.full_like(top_ids, -1))
    # certificate tightening: a lane that consumed every REAL block has
    # nothing un-enumerated — vacuous -inf bound; only a budget halt keeps
    # the live block bound
    full_steps = _cdiv(m, block_size)
    upper = torch.where(depth >= full_steps, neg_inf, upper)
    return TopKResult(top_vals, ids.to(torch.int32), n_scored,
                      depth * block_size, upper=upper)


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
