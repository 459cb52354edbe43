"""Embedding tables: lookup, the hash-trick lookup and the ragged
EmbeddingBag for recsys, the token lookup for the LM.

Recsys rows are taken as the reference's ``jnp.take`` takes them: an id
in ``[-V, 0)`` counts from the end of the table, any other out-of-range id
gives a NaN row. The LM's token rows are taken as the reference's
``table[tokens]`` takes them (:func:`index_rows`): out-of-range ids are
clamped into the table. Both functions are plain PyTorch, as the reference
computes them outside any Pallas kernel; the fixed-arity bag that the
recsys model runs on the card is kernel B5
(:func:`repro_torch.kernels.ops.embedding_bag`). :func:`hashed_lookup`
is the reference's hash-trick lookup, its uint32 hash computed in int64
without overflow.

Gradients. The lookups scatter their rows' gradients into the table
through :func:`repro_torch.kernels.embedding_bag.row_grad`: a stable sort
of the rows and a segmented sum in a fixed order, so two backward passes
on the card are bitwise equal (the backward of ``table[ids]`` and
``index_add_`` may add duplicate rows with atomics, in an order that
changes from run to run). The LM's token gradient is summed in float32.
The reference casts the whole table to the compute dtype and then
gathers (``params["embed"].astype(dt)[tokens]``), so at bf16 its
transpose is a bf16 scatter-add into a bf16 ``[V, D]`` buffer, then an
upcast; :func:`index_rows` gathers the fp32 rows and its backward sums in
fp32, which is deterministic and no less accurate.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag import row_grad, take_rows


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One-hot field lookup. table: ``[V, d]``; ids: ``[...]`` ->
    ``[..., d]``."""
    return take_rows(table, ids)


class _IndexRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.V = V = table.shape[0]
        row = torch.where(ids < 0, ids + V, ids)
        return table[row.clamp(0, V - 1).long()]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        d = grad.shape[-1]
        return (row_grad(ids, ctx.V, grad.reshape(-1, d), 1).to(grad.dtype),
                None)


def index_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as jnp's indexing takes rows: an id in ``[-V, 0)``
    counts from the end, any other id is clamped into ``[0, V)``.
    Never indexes out of range. Its gradient is :func:`row_grad`'s
    deterministic fp32 sum, into which an id outside ``[-V, V)`` adds
    nothing, as the transpose of jnp's gather drops it (the forward
    clamps it; the backward does not)."""
    return _IndexRows.apply(table, ids)


#: Knuth's multiplicative constant; probe ``i`` multiplies by
#: ``KNUTH + 2 * i + 1`` modulo 2**32
KNUTH = 2654435761
_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` and ``c`` in ``[0, 2**32)``,
    every intermediate below 2**49: ``c`` split into 16-bit halves, the
    high half's product masked to 16 bits before its shift."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hashed_lookup(table: torch.Tensor, raw_ids: torch.Tensor,
                  num_hashes: int = 2) -> torch.Tensor:
    """Hash-trick lookup for unbounded vocabularies (QR-style compromise):
    the mean of ``num_hashes`` universal-hash probes into one physical
    table ``[V, d]``. Probe ``i`` takes row ``(id mod 2**32) * (KNUTH + 2i
    + 1) mod 2**32 mod V``, as the reference's uint32 arithmetic does (a
    negative id wraps to its two's complement); rows go through
    :func:`take_rows`, whose gradient is deterministic."""
    V = table.shape[0]
    x = raw_ids.long() & _U32
    out = 0
    for i in range(num_hashes):
        h = _mul_u32(x, KNUTH + 2 * i + 1) % V
        out = out + take_rows(table, h.int())
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which rounds otherwise than jnp's division by 3
    return out / out.new_full((), num_hashes)


def embedding_bag(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-hot bag reduce: gather rows then segment-reduce per bag.

    Args:
      table: ``[V, d]``.
      flat_ids: ``[N]`` row indices (ragged bags flattened).
      segment_ids: ``[N]`` bag index per entry (sorted not required);
        entries outside ``[0, num_segments)`` are dropped, as
        ``jax.ops.segment_sum`` drops them.
      num_segments: number of bags.
      mode: ``sum`` | ``mean`` | ``max`` (an empty bag's max is -inf).
      weights: optional ``[N]`` per-entry weights (sum/mean only).
    """
    if mode not in ("sum", "mean", "max"):
        raise ValueError(f"unknown mode {mode}")
    rows = take_rows(table, flat_ids)                          # [N, d]
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    # dropped entries land in one extra segment, cut off at the end
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    seg = torch.where(keep, segment_ids,
                      torch.full_like(segment_ids, num_segments)).long()
    shape = (num_segments + 1, rows.shape[1])
    if mode == "max":
        out = torch.full(shape, float("-inf"), dtype=rows.dtype,
                         device=rows.device)
        out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows, "amax")
        return out[:num_segments]
    s = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
    s = s.index_add_(0, seg, rows)[:num_segments]
    if mode == "sum":
        return s
    c = torch.zeros(num_segments + 1, dtype=rows.dtype, device=rows.device)
    c = c.index_add_(0, seg, torch.ones_like(rows[:, 0]))[:num_segments]
    return s / torch.clamp(c, min=1.0)[:, None]
