"""Gather-fused scoring of scattered catalogue rows: the CUDA kernel's
wrapper and its plain PyTorch version.

``gather_scores(T, ids, U)`` computes ``out[b, c] = T[ids[b, c]] @ U[b]``
in fp32 for ``T [M, R]``, ``ids [B, C]`` int32 and ``U [B, R]``; the
one-query form takes ``ids [C]`` with ``u [R]`` and returns ``[C]``. Ids
may repeat. It is the tail scorer of the list engines
(:mod:`repro_torch.core.blocked`): a Block Threshold Algorithm step past
the contiguous list prefix scores ``R * block`` scattered catalogue rows
per lane, without materialising the gathered ``[B, C, R]`` rows.

An id outside ``[0, M)`` is the caller's error. Both versions score it
NaN (the kernel reads nothing for it), so it shows in any comparison.

The kernel has two paths (``csrc/gather_scores.cu``), and
:func:`launch_plan` picks one by shape: the *lane* path, where a block
stages each candidate column's shared rows (lane 0's id and the first
other one) in shared memory once and a thread scores one lane of a few
columns, and, for fewer than :data:`FEW_LANES` lanes, the *row* path,
where a warp reads one candidate row at a time across its columns.

:func:`gather_scores` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches ``csrc/gather_scores.cu`` or raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

#: Kernel limits (the wrapper raises above them): R bounds the row path's
#: shared-memory copy of a query, the lane count the grid's y dimension.
MAX_R = 4096
MAX_LANES = 65535
#: Below this many lanes the row path runs. ``chip_smoke.py``'s path sweep
#: on the main path's tail block (H100 80GB HBM3, 700 W; cold L2): the row
#: path is mostly faster at 1 and 2 lanes; at 3 and 4 lanes the two swing
#: either way by up to 23% between runs (launch-bound, so noise); they are
#: within 1% at 5, and the lane path is faster from 6.
FEW_LANES = 5
PATHS = ("rows", "lanes")
# the kernel's constants (csrc/gather_scores.cu): the row path's candidates
# a block; the lane path's columns a thread, floats of a staged row chunk
# and its row stride
ROWS_PER_BLOCK = 32
LANE_COLS = 4
ROW_CHUNK = 32
ROW_STRIDE = ROW_CHUNK + 4
#: The SMs of an H100 SXM: :func:`launch_plan`'s default, for plans made
#: off the card; the wrapper passes the device's own count.
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    path: str             # "rows" or "lanes"
    group: int            # lanes a block (G); 1 on the row path
    vec: int              # floats a row load (4, 2 or 1); 1 on the row path
    threads: int          # threads a block
    cols: int             # candidate columns a block
    grid: tuple           # (x, y)
    smem: int             # dynamic shared-memory bytes a block


def _lane_smem(G: int, cols: int) -> int:
    """Bytes of a lane-path block: the slots' row chunks and the queries'
    chunk (two buffers each), the ids tile and the columns' slot ids."""
    return 4 * (2 * (2 * cols * ROW_STRIDE + ROW_CHUNK * G)
                + G * (cols + 32 // G) + 2 * cols)


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, C: int, R: int, path: Optional[str] = None,
                address: int = 0, sms: int = H100_SMS) -> LaunchPlan:
    """How the kernel runs ``[B, C]`` ids over a rank-``R`` catalogue whose
    data starts at byte ``address`` (only its offset in 16 bytes counts;
    plans are cached) on a device of ``sms`` SMs: the row path for ``B <
    FEW_LANES`` (unless ``path`` names one), else the lane path with a
    lane group ``G`` of the power of two from 4 to 32 that ``B`` needs,
    the widest row load that ``R`` and the address allow, and a tile of
    up to 64 columns, :data:`LANE_COLS` a thread (at most 256 threads),
    halved down to 16 while the grid would hold fewer than two blocks an
    SM and a block keeps at least one warp."""
    if path is None:
        path = "rows" if B < FEW_LANES else "lanes"
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    if path == "rows":
        return LaunchPlan("rows", 1, 1, 256, ROWS_PER_BLOCK,
                          (-(-C // ROWS_PER_BLOCK), B), 4 * R)
    G = 4
    while G < 32 and G < B:
        G *= 2
    vec = next(v for v in (4, 2, 1)
               if R % v == 0 and address % (4 * v) == 0)
    cols = min(64, 256 * LANE_COLS // G)       # at most 256 threads
    while cols > max(16, 32 * LANE_COLS // G) and \
            -(-C // cols) * -(-B // G) < 2 * sms:
        cols //= 2
    return LaunchPlan("lanes", G, vec, cols * G // LANE_COLS, cols,
                      (-(-C // cols), -(-B // G)), _lane_smem(G, cols))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (read once a device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def gather_scores(T: torch.Tensor, ids: torch.Tensor, U: torch.Tensor,
                  path: Optional[str] = None) -> torch.Tensor:
    """``T[ids] @ u`` per lane (see the module docstring).

    CPU tensors run :func:`gather_scores_plain`; CUDA tensors launch the
    kernel on the current stream (``gather_scores.launches`` counts
    launches) and raise on anything the kernel does not take. ``path``
    (``"rows"`` or ``"lanes"``) overrides :func:`launch_plan`'s choice,
    for tests and measurements; both paths compute the same function.
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
    plan = launch_plan(B, C, R, path, T.data_ptr() % 16,
                       sm_count(T.device))
    from repro_torch.kernels._build import load
    lib = load("gather_scores")
    args = (T.data_ptr(), ids.data_ptr(), U.data_ptr(), out.data_ptr(),
            B, C, M, R)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        if plan.path == "rows":
            err = lib.gather_scores_rows_launch(*args, stream)
        else:
            err = lib.gather_scores_lanes_launch(
                *args, plan.group, plan.vec, plan.cols, plan.smem, stream)
    if err != 0:
        msg = lib.gather_scores_error_string(err).decode()
        raise RuntimeError(f"gather_scores launch failed: CUDA error {err} "
                           f"({msg})")
    gather_scores.launches += 1
    gather_scores.path_launches[plan.path] += 1
    return out


#: Launches of the CUDA kernel in this process (plain-version calls on
#: CPU tensors are not launches), in all and by path. Callers reset them
#: to 0 to count a run.
gather_scores.launches = 0
gather_scores.path_launches = dict.fromkeys(PATHS, 0)
