"""The FM second-order interaction: the CUDA kernel's wrapper and its
plain PyTorch version.

``fm_interaction(emb)`` computes Rendle's sum-square identity for field
embeddings ``emb [B, F, d]`` (float32 or float16)::

    out[b] = 0.5 * sum_d [ (sum_f v[b, f, d])^2 - sum_f v[b, f, d]^2 ]

accumulated in float32 and returned ``[B]`` in the input's dtype. It is the
FM term of the ``fm`` and ``deepfm`` models
(:mod:`repro_torch.models.recsys`). The kernel keeps both sums in
registers, so no ``[B, d]`` temporary reaches device memory.

This is the counterpart of the reference's ``kernels/ops.py:
fm_interaction``, which pads the batch to a multiple of ``block_b`` for
the Pallas grid and slices the result back; that padding and the
``block_b``/``interpret`` knobs are Pallas details the port leaves out.
:func:`fm_interaction` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches ``csrc/fm_interaction.cu`` or raises.
"""

from __future__ import annotations

import torch

DTYPES = (torch.float32, torch.float16)
#: Kernel limit (the wrapper raises above it): one bag's columns are
#: threads of one CUDA block.
MAX_D = 1024


def _check(emb: torch.Tensor) -> None:
    if emb.dim() != 3:
        raise ValueError(f"emb must be [B, F, d], got shape "
                         f"{tuple(emb.shape)}")


def fm_interaction_plain(emb: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (float32 sums, the
    reference's order of operations, the input's dtype out)."""
    _check(emb)
    v = emb.float()
    s = v.sum(dim=1)
    sq = (v * v).sum(dim=1)
    return (0.5 * (s * s - sq).sum(dim=-1)).to(emb.dtype)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """FM sum-square interaction, ``[B, F, d] -> [B]`` (see the module
    docstring).

    CPU tensors run :func:`fm_interaction_plain`; CUDA tensors launch the
    kernel on the current stream (``fm_interaction.launches`` counts
    launches) and raise on anything the kernel does not take.
    """
    _check(emb)
    if emb.device.type == "cpu":
        return fm_interaction_plain(emb)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    if emb.dtype not in DTYPES:
        raise ValueError("emb must be float32 or float16")
    if not emb.is_contiguous():
        raise ValueError("emb must be contiguous")
    B, F, d = emb.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"kernel limits: 1 <= d <= {MAX_D} (got {d})")
    out = torch.empty((B,), dtype=emb.dtype, device=emb.device)
    if B == 0:
        return out
    from repro_torch.kernels._build import load
    lib = load("fm_interaction")
    with torch.cuda.device(emb.device):
        err = lib.fm_interaction_launch(
            emb.data_ptr(), out.data_ptr(), B, F, d,
            int(emb.dtype == torch.float16),
            torch.cuda.current_stream(emb.device).cuda_stream)
    if err != 0:
        msg = lib.fm_interaction_error_string(err).decode()
        raise RuntimeError(f"fm_interaction launch failed: CUDA error {err} "
                           f"({msg})")
    fm_interaction.launches += 1
    return out


#: Launches of the CUDA kernel in this process (plain-version calls on
#: CPU tensors are not launches). Callers reset it to 0 to count a run.
fm_interaction.launches = 0
