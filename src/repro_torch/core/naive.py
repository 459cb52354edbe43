"""Naive exact top-K: score every target, keep the best K.

The paper's baseline (``O((R + log K) M)``): one matmul and a selection.
The selection is a STABLE descending sort, so equal scores rank the lower
item id first — the tie order of the reference's ``lax.top_k``
(``torch.topk`` makes no promise about ties).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TopKResult(NamedTuple):
    values: torch.Tensor   # [K] (or [B, K]) scores, descending
    indices: torch.Tensor  # [K] (or [B, K]) item ids
    n_scored: torch.Tensor  # scalar (or [B]) int32 — s(x,y) evaluations
    depth: torch.Tensor     # scalar (or [B]) int32 — depth reached
    # Scalar (or [B]) upper bound on the score of every item the scan did
    # NOT enumerate when it stopped (-inf when the scan saw everything).
    upper: Optional[torch.Tensor] = None


def stable_topk(scores: torch.Tensor, k: int):
    """Top-``k`` along the last axis, ties to the lower position."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def certificate_gaps(res: TopKResult) -> torch.Tensor:
    """Per-slot certificate gap ``upper - value``.

    ``gap <= 0`` certifies the slot: it provably belongs to the true
    top-K. Pad slots (``indices < 0``) get ``+inf``, which also avoids
    ``-inf - -inf = nan`` when the bound itself is ``-inf``.
    """
    if res.upper is None:
        raise ValueError(
            "result carries no upper bound; run a budget-capable engine "
            "(naive/norm) to obtain certificates")
    upper = torch.as_tensor(res.upper)
    gap = upper[..., None] - res.values
    return torch.where(res.indices >= 0, gap,
                       torch.full_like(gap, float("inf")))


def certified_counts(res: TopKResult) -> torch.Tensor:
    """Number of certified-exact prefix slots per query ([B] or scalar)."""
    return torch.sum(certificate_gaps(res) <= 0, dim=-1).to(torch.int32)


def naive_topk(targets: torch.Tensor, u: torch.Tensor, k: int) -> TopKResult:
    """Exact top-K by full scoring. ``targets: [M, R]``, ``u: [R] or [B, R]``."""
    scores = u @ targets.T
    values, indices = stable_topk(scores, k)
    batch_shape = scores.shape[:-1]
    dev = scores.device
    n_scored = torch.full(batch_shape, targets.shape[0], dtype=torch.int32,
                          device=dev)
    depth = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    upper = torch.full(batch_shape, float("-inf"), dtype=values.dtype,
                       device=dev)
    return TopKResult(values, indices.to(torch.int32), n_scored, depth,
                      upper=upper)
