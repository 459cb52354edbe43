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
for CUDA tensors it launches ``csrc/topk_mips.cu`` or raises. The kernel
runs in two phases: every tile of the live prefix scored once per query
group, each (query, tile)'s top ``min(k, block_m)`` kept, then one warp
per query walks the gate over those lists (tests/test_torch_topk_mips.py
holds that decomposition, in numpy, against :func:`topk_mips_plain`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.driver import merge_block_into_carry_batched

NEG_INF = -1e30

MODES = ("two_level_batched", "two_level_tile", "single_level")

#: Kernel limits (the wrapper raises above them): block_m bounds the
#: tile-score buffer and the per-tile selection, R the shared-memory ring
#: and query copy. k has no limit: the gate walk keeps its carry in shared
#: memory up to SMEM_K and in a global scratch above it (slower; the
#: streaming tier's over-fetch ladder reaches such k).
SMEM_K = 256
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


#: Bytes of phase-1 scratch one call holds at most. A batch whose scratch
#: would be larger runs in query slices that reuse one scratch.
SCRATCH_BYTES = 256 << 20


def query_slices(B: int, n_blocks: int, kk: int,
                 budget: int = SCRATCH_BYTES, k: int = 0) -> list:
    """``(b0, b1)`` query slices whose scratch — ``kk`` (value, row) pairs
    and one maximum per (query, tile), plus the gate walk's global carry
    of ``4 k + 2 kk`` words when ``k > SMEM_K`` — stays within ``budget``
    bytes (one query at the least); slices hold whole phase-1 groups of
    64 where they can."""
    per_query = n_blocks * (8 * kk + 4)
    if k > SMEM_K:
        per_query += 4 * (4 * k + 2 * kk)
    rows = max(1, budget // max(per_query, 1))
    if rows >= 64:
        rows -= rows % 64
    rows = min(rows, B)
    return [(b0, min(B, b0 + rows)) for b0 in range(0, B, rows)]


class KernelPhases:
    """The kernel's launches for one batch, with their outputs and scratch
    allocated (:meth:`run` runs them all; ``chip_smoke.py`` times each
    phase on its own).

    Phase 1 (``score``) scores every tile of each query group's live prefix
    once for the whole group and writes each (query, tile)'s top
    ``kk = min(k, block_m)`` rows and its maximum into the scratch; phase 2
    (``walk``) walks each query's gate over that scratch into ``vals``,
    ``idx`` and ``stats``. The batch runs in :func:`query_slices`, each
    scored and then walked over the one scratch. Takes CUDA tensors that
    passed the wrapper's checks.
    """

    def __init__(self, T_sorted, U, tile_bounds, live, k, block_m, mode,
                 superblock, num_real):
        from repro_torch.kernels._build import load
        self.lib = load("topk_mips")
        M_pad, R = T_sorted.shape
        B = U.shape[0]
        dev = T_sorted.device
        self.n_blocks = M_pad // block_m
        self.kk = min(k, block_m)
        self.slices = query_slices(B, self.n_blocks, self.kk, k=k)
        rows = self.slices[0][1]
        self.operands = (T_sorted, U, tile_bounds, live)
        self.shape = (R, block_m, superblock, k,
                      M_pad if num_real < 0 else num_real,
                      MODES.index(mode))
        self.vals = torch.empty((B, k), dtype=torch.float32, device=dev)
        self.idx = torch.empty((B, k), dtype=torch.int32, device=dev)
        self.stats = torch.empty((B, 3), dtype=torch.int32, device=dev)
        self.lvals = torch.empty((rows, self.n_blocks, self.kk),
                                 dtype=torch.float32, device=dev)
        self.lids = torch.empty_like(self.lvals, dtype=torch.int32)
        self.tmax = torch.empty((rows, self.n_blocks), dtype=torch.float32,
                                device=dev)
        # the gate walk's carry, merge buffer and candidates per query,
        # in global memory past SMEM_K (4-byte words; floats and ints)
        self.carry = (torch.empty((rows, 4 * k + 2 * self.kk),
                                  dtype=torch.float32, device=dev)
                      if k > SMEM_K else None)

    @property
    def scratch_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.lvals, self.lids, self.tmax, self.carry)
                   if t is not None)

    def _raise_on(self, err: int, phase: str) -> None:
        if err != 0:
            msg = self.lib.topk_mips_error_string(err).decode()
            raise RuntimeError(f"topk_mips {phase} launch failed: CUDA "
                               f"error {err} ({msg})")

    def _stream(self):
        return torch.cuda.current_stream(self.vals.device).cuda_stream

    @staticmethod
    def _ptr(t, b0):
        """Address of row ``b0`` of ``t`` (None for an absent ``live``)."""
        return None if t is None else t[b0:].data_ptr()

    def score(self, i: int = 0) -> None:
        """Phase 1 on query slice ``i``."""
        T, U, _, live = self.operands
        b0, b1 = self.slices[i]
        R, block_m, superblock, _, num_real, mode = self.shape
        with torch.cuda.device(self.vals.device):
            err = self.lib.topk_mips_score_launch(
                T.data_ptr(), self._ptr(U, b0), self._ptr(live, b0),
                self.lvals.data_ptr(), self.lids.data_ptr(),
                self.tmax.data_ptr(), b1 - b0, R, self.n_blocks, block_m,
                superblock, self.kk, num_real, mode, self._stream())
        self._raise_on(err, "score")

    def walk(self, i: int = 0) -> None:
        """Phase 2 on query slice ``i`` (after its phase 1)."""
        _, _, bounds, live = self.operands
        b0, b1 = self.slices[i]
        _, block_m, superblock, k, _, mode = self.shape
        with torch.cuda.device(self.vals.device):
            err = self.lib.topk_mips_walk_launch(
                self._ptr(bounds, b0), self._ptr(live, b0),
                self.lvals.data_ptr(), self.lids.data_ptr(),
                self.tmax.data_ptr(), self._ptr(self.vals, b0),
                self._ptr(self.idx, b0), self._ptr(self.stats, b0),
                self._ptr(self.carry, 0), b1 - b0,
                self.n_blocks, block_m, superblock, k, self.kk, mode,
                self._stream())
        self._raise_on(err, "walk")

    def run(self):
        """Both phases over every slice; returns ``(vals, idx, stats)``."""
        for i in range(len(self.slices)):
            self.score(i)
            self.walk(i)
        return self.vals, self.idx, self.stats


def _check_cuda(T_sorted, U, tile_bounds, live, k, block_m):
    R = T_sorted.shape[1]
    if block_m > MAX_BLOCK_M or R > MAX_R:
        raise ValueError(f"kernel limits: block_m <= {MAX_BLOCK_M} (got "
                         f"{block_m}), R <= {MAX_R} (got {R})")
    f32 = (T_sorted, U, tile_bounds)
    if any(t.dtype != torch.float32 for t in f32) or (
            live is not None and live.dtype != torch.int32):
        raise ValueError("T_sorted/U/tile_bounds must be float32, live int32")
    if not all(t.is_contiguous() for t in f32 + (() if live is None
                                                 else (live,))):
        raise ValueError("operands must be contiguous")
    if T_sorted.data_ptr() % 16:
        raise ValueError("T_sorted must start on a 16-byte boundary (the "
                         "kernel stages its rows with bulk copies)")


def topk_mips(T_sorted: torch.Tensor, U: torch.Tensor,
              tile_bounds: torch.Tensor, live: Optional[torch.Tensor],
              k: int, *, block_m: int, mode: str, superblock: int = 1,
              num_real: int = -1):
    """Exact blocked MIPS top-K (see the module docstring).

    CPU tensors run :func:`topk_mips_plain`; CUDA tensors launch the
    kernel's two phases (:class:`KernelPhases`) on the current stream and
    raise on anything the kernel does not take. ``topk_mips.launches``
    counts calls that launched the kernel, one per batch (each launches
    both phases, once per query slice).
    """
    k = int(k)
    _check(T_sorted, U, tile_bounds, live, k, block_m, mode, superblock)
    if T_sorted.device.type == "cpu":
        return topk_mips_plain(T_sorted, U, tile_bounds, live, k,
                               block_m=block_m, mode=mode,
                               superblock=superblock, num_real=num_real)
    if T_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {T_sorted.device}")
    _check_cuda(T_sorted, U, tile_bounds, live, k, block_m)
    B = U.shape[0]
    if B == 0:
        dev = T_sorted.device
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, 3), dtype=torch.int32, device=dev))
    out = KernelPhases(T_sorted, U, tile_bounds, live, k, block_m, mode,
                       superblock, num_real).run()
    topk_mips.launches += 1
    topk_mips.path_launches[CARRIES[k > SMEM_K]] += 1
    return out


#: The gate walk's carry: in shared memory up to SMEM_K, global above.
CARRIES = ("shared_carry", "global_carry")

#: Calls that launched the CUDA kernel in this process, one per query
#: batch (its two phases together; plain-version calls on CPU tensors are
#: not launches), and the same calls by where the walk kept its carry.
#: Callers reset them to 0 to count a run.
topk_mips.launches = 0
topk_mips.path_launches = dict.fromkeys(CARRIES, 0)
