"""Plain-PyTorch oracles for the port's kernels (the allclose targets),
copies of the reference's ``kernels/ref.py``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.naive import stable_topk
from repro_torch.kernels.embedding_bag import take_rows


def topk_mips_ref(T_sorted: torch.Tensor, u: torch.Tensor, k: int):
    """Exact top-K over the norm-ordered catalogue; ids are positions in
    ``T_sorted`` (``MIPSCatalog`` maps them back through the permutation).
    Ties go to the lower position, as ``lax.top_k``'s do."""
    vals, idx = stable_topk(T_sorted @ u, k)
    return vals, idx.to(torch.int32)


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      mode: str = "sum") -> torch.Tensor:
    """ids: ``[B, F]`` fixed-size bags -> ``[B, d]``, in the table's dtype.
    Rows are taken as ``jnp.take`` takes them: an out-of-range id gives a
    NaN row."""
    rows = take_rows(table, ids)                   # [B, F, d]
    if weights is not None:
        rows = rows * weights[..., None]
    if mode == "sum":
        return rows.sum(dim=1)
    if mode == "mean":
        return rows.mean(dim=1)
    raise ValueError(mode)


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    """emb: ``[B, F, d]`` -> ``[B]`` Rendle sum-square second-order term."""
    s = emb.sum(dim=1)
    sq = (emb * emb).sum(dim=1)
    return 0.5 * (s * s - sq).sum(dim=-1)
