"""Embedding tables: lookup and the ragged EmbeddingBag for recsys, the
token lookup for the LM.

Recsys rows are taken as the reference's ``jnp.take`` takes them: an id
in ``[-V, 0)`` counts from the end of the table, any other out-of-range id
gives a NaN row. The LM's token rows are taken as the reference's
``table[tokens]`` takes them (:func:`index_rows`): out-of-range ids are
clamped into the table. Both functions are plain PyTorch, as the reference
computes them outside any Pallas kernel; the fixed-arity bag that the
recsys model runs on the card is kernel B5
(:func:`repro_torch.kernels.ops.embedding_bag`). ``hashed_lookup`` (the
reference's hash-trick lookup) is a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag import take_rows


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One-hot field lookup. table: ``[V, d]``; ids: ``[...]`` ->
    ``[..., d]``."""
    return take_rows(table, ids)


def index_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as jnp's indexing takes rows: an id in ``[-V, 0)``
    counts from the end, any other id is clamped into ``[0, V)``.
    Never indexes out of range."""
    V = table.shape[0]
    row = torch.where(ids < 0, ids + V, ids)
    return table[row.clamp(0, V - 1).long()]


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
