"""Gather-fused scoring of scattered catalogue rows: the CUDA kernel's
wrapper and its plain PyTorch version.

``gather_scores(T, ids, U)`` computes ``out[b, c] = T[ids[b, c]] @ U[b]``
in fp32 for ``T [M, R]``, ``ids [B, C]`` int32 and ``U [B, R]``; the
one-query form takes ``ids [C]`` with ``u [R]`` and returns ``[C]``. Ids
may repeat. It is the tail scorer of the list engines
(:mod:`repro_torch.core.blocked`): a Block Threshold Algorithm step past
the contiguous list prefix scores ``R * block`` scattered catalogue rows
per lane, and the kernel reads each row once per candidate without
materialising the gathered ``[B, C, R]`` rows.

An id outside ``[0, M)`` is the caller's error. Both versions score it
NaN (the kernel reads nothing for it), so it shows in any comparison.

:func:`gather_scores` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches ``csrc/gather_scores.cu`` or raises.
"""

from __future__ import annotations

import torch

#: Kernel limits (the wrapper raises above them): R bounds the query's
#: shared-memory copy, the lane count the grid's y dimension.
MAX_R = 4096
MAX_LANES = 65535


def _check(T: torch.Tensor, ids: torch.Tensor, U: torch.Tensor) -> None:
    if T.dim() != 2:
        raise ValueError(f"T must be [M, R], got shape {tuple(T.shape)}")
    if ids.dim() not in (1, 2) or U.dim() != ids.dim():
        raise ValueError("pass ids [C] with u [R], or ids [B, C] with "
                         f"U [B, R]; got ids {tuple(ids.shape)} and U "
                         f"{tuple(U.shape)}")
    if ids.dim() == 2 and ids.shape[0] != U.shape[0]:
        raise ValueError(f"ids has {ids.shape[0]} lanes, U {U.shape[0]}")
    if U.shape[-1] != T.shape[1]:
        raise ValueError(f"query rank {U.shape[-1]} != catalogue rank "
                         f"{T.shape[1]}")
    if len({T.device, ids.device, U.device}) != 1:
        raise ValueError("all operands must be on one device")


def gather_scores_plain(T: torch.Tensor, ids: torch.Tensor,
                        U: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (materialises the gathered
    rows; out-of-range ids score NaN)."""
    _check(T, ids, U)
    one = ids.dim() == 1
    ids2, U2 = (ids[None], U[None]) if one else (ids, U)
    valid = (ids2 >= 0) & (ids2 < T.shape[0])
    rows = T[torch.where(valid, ids2, torch.zeros_like(ids2)).long()]
    out = (rows * U2[:, None, :]).sum(-1)
    out = torch.where(valid, out, torch.full_like(out, float("nan")))
    return out[0] if one else out


def gather_scores(T: torch.Tensor, ids: torch.Tensor,
                  U: torch.Tensor) -> torch.Tensor:
    """``T[ids] @ u`` per lane (see the module docstring).

    CPU tensors run :func:`gather_scores_plain`; CUDA tensors launch the
    kernel on the current stream (``gather_scores.launches`` counts
    launches) and raise on anything the kernel does not take.
    """
    _check(T, ids, U)
    if T.device.type == "cpu":
        return gather_scores_plain(T, ids, U)
    if T.device.type != "cuda":
        raise ValueError(f"unsupported device {T.device}")
    if T.dtype != torch.float32 or U.dtype != torch.float32 \
            or ids.dtype != torch.int32:
        raise ValueError("T and U must be float32, ids int32")
    if not (T.is_contiguous() and ids.is_contiguous()
            and U.is_contiguous()):
        raise ValueError("operands must be contiguous")
    M, R = T.shape
    B = 1 if ids.dim() == 1 else ids.shape[0]
    C = ids.shape[-1]
    if R > MAX_R or B > MAX_LANES:
        raise ValueError(f"kernel limits: R <= {MAX_R} (got {R}), lanes <= "
                         f"{MAX_LANES} (got {B})")
    out = torch.empty(ids.shape, dtype=torch.float32, device=T.device)
    if B == 0 or C == 0:
        return out
    from repro_torch.kernels._build import load
    lib = load("gather_scores")
    with torch.cuda.device(T.device):
        err = lib.gather_scores_launch(
            T.data_ptr(), ids.data_ptr(), U.data_ptr(), out.data_ptr(),
            B, C, M, R, torch.cuda.current_stream(T.device).cuda_stream)
    if err != 0:
        msg = lib.gather_scores_error_string(err).decode()
        raise RuntimeError(f"gather_scores launch failed: CUDA error {err} "
                           f"({msg})")
    gather_scores.launches += 1
    return out


#: Launches of the CUDA kernel in this process (plain-version calls on
#: CPU tensors are not launches). Callers reset it to 0 to count a run.
gather_scores.launches = 0
