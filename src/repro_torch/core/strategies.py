"""The list scan strategies of the Block Threshold Algorithm.

The sign bucket of a batch (:func:`sign_bucket`), the round-major
first-occurrence keys that answer freshness, and
:func:`batched_list_prefix_strategy`, the
:class:`repro_torch.core.driver.BatchedScanStrategy` of the contiguous
:class:`repro_torch.core.layout.ListMajorLayout` prefix for
:func:`repro_torch.core.driver.batched_pruned_scan`: one shared tile per
step, per-query scores, bounds and freshness. Past the prefix the scan
continues on the gather side (:mod:`repro_torch.core.blocked`), whose
candidates are scored by kernel B4. One query is the batch of one.

Invariants kept from the reference: masking and placement use
``torch.where``, never a multiplication (``-inf`` carries); zero query
weights deactivate their lists; every freshness path reduces to the same
round-major first-occurrence key (:func:`_keys_from_ranks`), so the
prefix, the tail and the gather path agree bit for bit.

The port runs on the real catalogue size ``M``: no array is padded to an
M-bucket, so no strategy takes the reference's ``m_real``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.driver import BatchedScanStrategy, lane_pieces

_INT_MAX = 2147483647


def sign_bucket(U) -> tuple:
    """Sign bucket of a query batch: ``(sign, dense)``.

    ``sign`` is ``+1`` when every weight is >= 0 (the scan only walks
    HEAD prefixes), ``-1`` when every weight is <= 0 (tail prefixes only),
    ``0`` otherwise (mixed — per-(query, list) direction select).
    ``dense`` is True when NO weight is zero, which lets a single-sign
    batch share one freshness-key tile; the mixed bucket always reports
    ``dense=False``. A tensor on the card costs one read of three flags.
    """
    if isinstance(U, torch.Tensor):
        if U.numel() == 0:
            return (0, False)
        has_neg, has_pos, has_zero = torch.stack(
            [(U < 0).any(), (U > 0).any(), (U == 0).any()]).tolist()
    else:
        arr = np.asarray(U)
        if arr.size == 0:
            return (0, False)
        has_neg = bool((arr < 0).any())
        has_pos = bool((arr > 0).any())
        has_zero = bool((arr == 0).any())
    if has_neg and has_pos:
        return (0, False)
    return ((-1, not has_zero) if has_neg else (1, not has_zero))


def sign_bucket_label(bucket: tuple) -> str:
    """Readable label for a :func:`sign_bucket` value (stats)."""
    if not bucket:
        return "unbucketed"
    sign, dense = bucket
    name = {1: "nonneg", -1: "nonpos", 0: "mixed"}[sign]
    return f"{name}-{'dense' if dense else 'sparse'}"


def _keys_from_ranks(ranks: torch.Tensor, u: torch.Tensor,
                     m: int) -> torch.Tensor:
    """Round-major first-occurrence keys from a ``[..., R]`` rank array.

    The sequential scan enumerates ROUND-major (depth d, then list r), so
    an item's first enumeration is the minimum of ``pos_r(y) * R + r``
    over its active lists, where ``pos_r`` is the walk position in list r
    (``m-1-rank`` when ``u_r < 0``). Zero-weight lists are masked to
    int32 max. A slot ``(r, d)`` is fresh iff its item's key is
    ``d*R + r``. ``u`` broadcasts against ``ranks`` by trailing axes:
    ``[R]`` for one query, ``[L, 1, ..., R]`` for ``L`` lanes.
    """
    R = ranks.shape[-1]
    pos = torch.where(u < 0, m - 1 - ranks, ranks)
    keys = pos * R + torch.arange(R, dtype=ranks.dtype, device=ranks.device)
    keys = torch.where(u != 0, keys, _INT_MAX)
    return keys.amin(dim=-1)


def rank_gather_first_keys(rank_by_item: torch.Tensor, U: torch.Tensor,
                           ids: torch.Tensor) -> torch.Tensor:
    """Keys for one block of candidates of ``L`` lanes, by row gather of
    ``rank_by_item [M, R]``: ``ids [L, C]`` with ``U [L, R]`` gives
    ``[L, C]``, a piece of lanes at a time
    (:func:`repro_torch.core.driver.lane_pieces`), so the ``[L, C, R]``
    rank rows never exist at once."""
    m = rank_by_item.shape[0]
    per_lane = ids.shape[1] * rank_by_item.shape[1]
    return torch.cat([
        _keys_from_ranks(rank_by_item[ids[p].long()], U[p, None, :], m)
        for p in lane_pieces(ids.shape[0], per_lane)])


def batched_list_prefix_strategy(layout, t_sorted_desc: torch.Tensor,
                                 U: torch.Tensor, block_size: int,
                                 sign: int = 0, dense: bool = False,
                                 ta_rounds: bool = False
                                 ) -> BatchedScanStrategy:
    """Gather-free BTA enumeration over the contiguous list prefix, for a
    whole batch: one shared tile per step.

    Block ``step`` covers depths ``[step*B, (step+1)*B)`` of every list,
    read from the layout's head tiles (descending walks) or tail tiles
    (negative weights). Covers ``layout.prefix_steps(block_size)`` blocks;
    the caller chains a gather-side tail for a scan that outlives it.

    The whole batch consumes the SAME prefix block each step, so the tile
    is sliced once and scored with one ``[C, R] @ [R, B]`` matmul. What
    stays per query is what the sequential semantics need: scores, Eq. 3
    bounds and freshness masks.

    ``sign`` is the batch's sign bucket (:func:`sign_bucket`): ``+1``
    reads only the HEAD tiles, ``-1`` only the TAIL tiles (candidate ids
    then are one shared ``[C]`` vector), ``0`` reads both and selects per
    (query, list). ``dense`` (no zero weight, single sign only) makes the
    freshness keys query-independent: one ``[R, block]`` key tile for the
    batch, evaluated with a constant direction of the bucket's sign. The
    caller guarantees that the bucket matches the batch.

    ``ta_rounds`` with ``block_size > 1`` is chunked TA: each of a block's
    depths is its own sequential round, with its own Eq. 3 bound per
    query (``bound`` returns ``[B, block_size]``), and the driver replays
    the rounds (:func:`repro_torch.core.driver.replay_rounds`).
    """
    side_ids = layout.head_ids if sign >= 0 else layout.tail_ids
    R = side_ids.shape[0]
    m = layout.rank_by_item.shape[0]
    dev = side_ids.device
    B = U.shape[0]
    C = R * block_size
    neg = U < 0                                                # [B, R]
    active = U != 0
    slot_key = (torch.arange(block_size, device=dev)[None, :] * R
                + torch.arange(R, device=dev)[:, None])        # [R, Bk]
    per_lane = R * block_size * R

    def _slice(arr, step):
        d0 = step * block_size
        return arr[:, d0:d0 + block_size]

    def _fresh(fk, abs_key):
        return ((fk == abs_key[None]) & active[:, :, None]).reshape(B, C)

    def _single_sign_block(step):
        if sign > 0:
            ids_a, rows_a, ranks_a = (layout.head_ids, layout.head_rows,
                                      layout.head_ranks)
        else:
            ids_a, rows_a, ranks_a = (layout.tail_ids, layout.tail_rows,
                                      layout.tail_ranks)
        ids = _slice(ids_a, step).reshape(-1)                  # [C] shared
        tile = _slice(rows_a, step).reshape(C, R)
        scores = (tile @ U.T).T                                # [B, C]
        ranks = _slice(ranks_a, step)                          # [R, Bk, R]
        abs_key = step * block_size * R + slot_key             # [R, Bk]
        if dense:
            u_dir = torch.full((R,), float(sign), dtype=U.dtype, device=dev)
            fk = _keys_from_ranks(ranks, u_dir, m)             # [R, Bk]
            return ids, scores, (fk == abs_key).reshape(1, C).expand(B, C)
        fk = torch.cat([_keys_from_ranks(ranks, U[p, None, None, :], m)
                        for p in lane_pieces(B, per_lane)])   # [B, R, Bk]
        return ids, scores, _fresh(fk, abs_key)

    def _mixed_block(step):
        h_ids = _slice(layout.head_ids, step)                  # [R, Bk]
        t_ids = _slice(layout.tail_ids, step)
        ids = torch.where(neg[:, :, None], t_ids[None],
                          h_ids[None]).reshape(B, C)           # [B, C]
        sh = (_slice(layout.head_rows, step).reshape(C, R) @ U.T).T
        st = (_slice(layout.tail_rows, step).reshape(C, R) @ U.T).T
        scores = torch.where(neg.repeat_interleave(block_size, dim=1),
                             st, sh)
        h_rk = _slice(layout.head_ranks, step)                 # [R, Bk, R]
        t_rk = _slice(layout.tail_ranks, step)
        fk = torch.cat([
            _keys_from_ranks(torch.where(neg[p, :, None, None], t_rk, h_rk),
                             U[p, None, None, :], m)
            for p in lane_pieces(B, per_lane)])               # [B, R, Bk]
        return ids, scores, _fresh(fk, step * block_size * R + slot_key)

    u_pos = torch.where(neg, 0.0, U)                           # [B, R]
    u_neg = torch.where(neg, U, 0.0)

    def round_bounds(step):
        # Eq. 3 at every depth of the block, per query: [B, Bk]; the
        # prefix never reaches the catalogue end, so no depth clamps
        d0 = step * block_size
        t_h = t_sorted_desc[:, d0:d0 + block_size]
        if sign > 0:
            return U @ t_h
        # ascending walk: column j holds t[:, m-1-(d0+j)]
        t_t = t_sorted_desc[:, m - block_size - d0:m - d0].flip(1)
        if sign < 0:
            return U @ t_t
        return u_pos @ t_h + u_neg @ t_t

    def block_bound(step):
        # bound at the block's last depth only — one [R] column per side
        end = step * block_size + block_size - 1
        t_h = t_sorted_desc[:, end]
        if sign > 0:
            return U @ t_h
        t_t = t_sorted_desc[:, m - 1 - end]
        if sign < 0:
            return U @ t_t
        return u_pos @ t_h + u_neg @ t_t

    block = _single_sign_block if sign != 0 else _mixed_block
    n_steps = layout.prefix_steps(block_size)
    if ta_rounds and block_size > 1:
        return BatchedScanStrategy(block=block, bound=round_bounds,
                                   num_steps=n_steps,
                                   rounds_per_step=block_size)
    return BatchedScanStrategy(block=block, bound=block_bound,
                               num_steps=n_steps)
