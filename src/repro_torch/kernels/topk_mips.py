"""Threshold-pruned blocked MIPS top-K: the CUDA kernel's wrapper and its
plain PyTorch version.

The catalogue ``T_sorted [M_pad, R]`` is in DECREASING-NORM order and
split into tiles of ``block_m`` rows. Per query the scan walks the first
``n_tiles`` tiles in order; a tile whose bound ``tile_bounds[b, t]`` (the
Cauchy-Schwarz ``||u|| * max_norm(tile)``) is strictly above the running
K-th best is scored and merged into the carried top-K. The three modes
differ only in how ``n_tiles`` — the live prefix the host pre-screen left
— is given, and so in stats column 2:

``two_level_batched``  ``live[b]`` live SUPERBLOCKS of ``superblock`` tiles
                        (Pallas ``topk_mips_pallas_batched_prefetch``)
``two_level_tile``     ``live[b]`` live TILES
                        (Pallas ``topk_mips_pallas_prefetch``)
``single_level``       no pre-screen: every tile is walked
                        (Pallas ``topk_mips_pallas`` and ``_batched``)

Returns ``(values [B, k] f32, local row ids [B, k] i32, stats [B, 3] i32)``
with stats = (rows scored incl. padding, tiles visited, tiles loaded).
Rows at or past ``num_real`` are zero padding and score ``NEG_INF``.

:func:`topk_mips` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches ``csrc/topk_mips.cu`` or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.driver import merge_block_into_carry_batched

NEG_INF = -1e30

MODES = ("two_level_batched", "two_level_tile", "single_level")

#: Kernel limits (the wrapper raises above them): k and block_m bound the
#: shared-memory merge, R the shared-memory copy of the query.
MAX_K = 256
MAX_BLOCK_M = 1024
MAX_R = 4096


def _live_tiles(mode: str, live: Optional[torch.Tensor], B: int,
               n_blocks: int, superblock: int) -> torch.Tensor:
    """Per-query count of tiles the scan walks (stats column 2)."""
    if mode == "single_level":
        return torch.full((B,), n_blocks, dtype=torch.int32)
    scale = superblock if mode == "two_level_batched" else 1
    return torch.clamp(live.to(torch.int32) * scale, 0, n_blocks)


def topk_mips_plain(T_sorted: torch.Tensor, U: torch.Tensor,
                    tile_bounds: torch.Tensor, live: Optional[torch.Tensor],
                    k: int, *, block_m: int, mode: str, superblock: int = 1,
                    num_real: int = -1):
    """The kernel's function in plain PyTorch: tiles in the outer loop,
    the batch vectorised, every state update gated per query."""
    _check(T_sorted, U, tile_bounds, live, k, block_m, mode, superblock)
    M_pad, _ = T_sorted.shape
    B = U.shape[0]
    n_blocks = M_pad // block_m
    num_real = M_pad if num_real < 0 else num_real
    dev = T_sorted.device
    n_tiles = _live_tiles(mode, live, B, n_blocks, superblock).to(dev)
    vals = torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    scored = torch.zeros((B,), dtype=torch.int32, device=dev)
    visited = torch.zeros((B,), dtype=torch.int32, device=dev)
    offs = torch.arange(block_m, dtype=torch.int32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    n_steps = int(n_tiles.max()) if B else 0
    for t in range(n_steps):
        gate = (t < n_tiles) & (tile_bounds[:, t] > vals[:, k - 1])
        rows = t * block_m + offs
        scores = U @ T_sorted[t * block_m:(t + 1) * block_m].T
        scores = torch.where(rows[None, :] < num_real, scores, neg)
        nv, ni = merge_block_into_carry_batched(vals, idx, scores, rows, k)
        vals = torch.where(gate[:, None], nv, vals)
        idx = torch.where(gate[:, None], ni, idx)
        scored += gate.to(torch.int32) * block_m
        visited += gate.to(torch.int32)
    return vals, idx, torch.stack([scored, visited, n_tiles], dim=1)


def _check(T_sorted, U, tile_bounds, live, k, block_m, mode, superblock):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    if T_sorted.dim() != 2 or U.dim() != 2:
        raise ValueError("T_sorted must be [M, R] and U [B, R]")
    M_pad, R = T_sorted.shape
    B = U.shape[0]
    if U.shape[1] != R:
        raise ValueError(f"query rank {U.shape[1]} != catalogue rank {R}")
    if block_m <= 0 or M_pad % block_m:
        raise ValueError(f"M={M_pad} is not a multiple of block_m={block_m}")
    if tuple(tile_bounds.shape) != (B, M_pad // block_m):
        raise ValueError(f"tile_bounds {tuple(tile_bounds.shape)} != "
                         f"{(B, M_pad // block_m)}")
    if mode == "single_level":
        if live is not None:
            raise ValueError("single_level takes no live counts")
    elif live is None or tuple(live.shape) != (B,):
        raise ValueError(f"{mode} needs live counts of shape ({B},)")
    if mode == "two_level_batched" and (M_pad // block_m) % superblock:
        raise ValueError("tiles are not a multiple of superblock")
    if not 0 < k:
        raise ValueError(f"k must be positive, got {k}")
    tensors = [T_sorted, U, tile_bounds] + ([] if live is None else [live])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")


def topk_mips(T_sorted: torch.Tensor, U: torch.Tensor,
              tile_bounds: torch.Tensor, live: Optional[torch.Tensor],
              k: int, *, block_m: int, mode: str, superblock: int = 1,
              num_real: int = -1):
    """Exact blocked MIPS top-K (see the module docstring).

    CPU tensors run :func:`topk_mips_plain`; CUDA tensors launch the
    kernel on the current stream (``topk_mips.launches`` counts launches)
    and raise on anything the kernel does not take.
    """
    k = int(k)
    _check(T_sorted, U, tile_bounds, live, k, block_m, mode, superblock)
    if T_sorted.device.type == "cpu":
        return topk_mips_plain(T_sorted, U, tile_bounds, live, k,
                               block_m=block_m, mode=mode,
                               superblock=superblock, num_real=num_real)
    if T_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {T_sorted.device}")
    M_pad, R = T_sorted.shape
    if k > MAX_K or block_m > MAX_BLOCK_M or R > MAX_R:
        raise ValueError(f"kernel limits: k <= {MAX_K} (got {k}), block_m "
                         f"<= {MAX_BLOCK_M} (got {block_m}), R <= {MAX_R} "
                         f"(got {R})")
    f32 = (T_sorted, U, tile_bounds)
    if any(t.dtype != torch.float32 for t in f32) or (
            live is not None and live.dtype != torch.int32):
        raise ValueError("T_sorted/U/tile_bounds must be float32, live int32")
    if not all(t.is_contiguous() for t in f32 + (() if live is None
                                                 else (live,))):
        raise ValueError("operands must be contiguous")
    B = U.shape[0]
    dev = T_sorted.device
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 3), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx, stats
    from repro_torch.kernels._build import load
    lib = load("topk_mips")
    num_real = M_pad if num_real < 0 else num_real
    with torch.cuda.device(dev):
        err = lib.topk_mips_launch(
            T_sorted.data_ptr(), U.data_ptr(), tile_bounds.data_ptr(),
            None if live is None else live.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), stats.data_ptr(),
            B, R, M_pad // block_m, block_m, superblock, k, num_real,
            MODES.index(mode), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.topk_mips_error_string(err).decode()
        raise RuntimeError(f"topk_mips launch failed: CUDA error {err} "
                           f"({msg})")
    topk_mips.launches += 1
    return vals, idx, stats


#: Launches of the CUDA kernel in this process (plain-version calls on
#: CPU tensors are not launches). Callers reset it to 0 to count a run.
topk_mips.launches = 0
