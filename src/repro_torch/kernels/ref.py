"""Plain-PyTorch oracle for the top-K MIPS kernel (the allclose target)."""

from __future__ import annotations

import torch

from repro_torch.core.naive import stable_topk


def topk_mips_ref(T_sorted: torch.Tensor, u: torch.Tensor, k: int):
    """Exact top-K over the norm-ordered catalogue; ids are positions in
    ``T_sorted`` (``MIPSCatalog`` maps them back through the permutation).
    Ties go to the lower position, as ``lax.top_k``'s do."""
    vals, idx = stable_topk(T_sorted @ u, k)
    return vals, idx.to(torch.int32)
