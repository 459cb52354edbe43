"""The kernels' public entry points.

``MIPSCatalog`` is the catalogue preparation around the top-K MIPS kernel.
It handles norm ordering, padding, the per-tile and per-superblock max
norms and the ``lb0`` pre-screen, and it maps kernel-local row ids back to
catalogue ids. The kernel itself stays shape-strict
(:mod:`repro_torch.kernels.topk_mips`).

``embedding_bag(table, ids, mode="sum")`` and ``fm_interaction(emb)`` are
the recsys kernels' entry points, the counterparts of the reference's
``ops.embedding_bag`` and ``ops.fm_interaction``. The reference pads the
batch to a multiple of ``block_b`` for its Pallas grid and slices the
result back; the port's kernels take any batch, so that padding and the
``block_b``/``interpret`` knobs are left out
(:mod:`repro_torch.kernels.embedding_bag`,
:mod:`repro_torch.kernels.fm_interaction`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.index import to_host
from repro_torch.core.naive import stable_topk
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: F401
from repro_torch.kernels.fm_interaction import fm_interaction  # noqa: F401
from repro_torch.kernels.topk_mips import NEG_INF, topk_mips


class MIPSCatalog:
    """Norm-ordered, block-padded catalogue for the top-K MIPS kernel.

    Owns the TWO-LEVEL bound hierarchy: per-tile Cauchy-Schwarz bounds for
    the in-kernel runtime test, plus a superblock-granular pre-screen from
    an a-priori lower bound lb0 — the K-th best score of the first
    (largest-norm) superblock, one matmul before the kernel launches.
    Tiles whose bound is already below lb0 form a suffix that the kernel
    never reads. The pre-screen can only drop tiles the runtime test would
    drop anyway (lb0 is a true lower bound on the final K-th best), so
    results AND statistics match the single-level scan exactly.

    Args:
      T: ``[M, R]`` catalogue (host array or tensor).
      block_m: tile rows (the runtime bound-test granularity).
      superblock: tiles per superblock — the pre-screen granularity
        (clamped to the tile count of small catalogues).
      device: where the catalogue lives (``None`` = ``cuda``).
    """

    def __init__(self, T, block_m: int = 256, superblock: int = 8,
                 device=None):
        T = to_host(T).astype(np.float32, copy=False)
        M, R = T.shape
        norms = np.linalg.norm(T, axis=1)
        order = np.argsort(-norms, kind="stable")
        superblock = int(max(1, min(superblock, -(-M // block_m))))
        span = block_m * superblock
        M_pad = -(-M // span) * span
        T_sorted = np.zeros((M_pad, R), np.float32)
        T_sorted[:M] = T[order]
        # max norm per tile/superblock = norm of its first row (sorted)
        norms_pad = np.pad(norms[order], (0, M_pad - M))
        self._set_state(T_sorted, order.astype(np.int32),
                        norms_pad[::block_m], norms_pad[::span], M, block_m,
                        superblock, resolve_device(device))

    @classmethod
    def from_state(cls, T_sorted, order, block_max_norm, super_max_norm,
                   num_real: int, block_m: int, superblock: int,
                   device=None) -> "MIPSCatalog":
        """A catalogue over already-prepared arrays (e.g. the reference's,
        through :func:`repro_torch.convert.from_reference`)."""
        cat = cls.__new__(cls)
        cat._set_state(T_sorted, order, block_max_norm, super_max_norm,
                       num_real, block_m, superblock, resolve_device(device))
        return cat

    def _set_state(self, T_sorted, order, block_max_norm, super_max_norm,
                   num_real, block_m, superblock, dev):
        def put(a, dtype):
            # a copy: the source may be a read-only view (reference state)
            return torch.tensor(to_host(a), dtype=dtype, device=dev)

        self.device = dev
        self.block_m = int(block_m)
        self.superblock = int(superblock)
        self.num_real = int(num_real)
        self.T_sorted = put(T_sorted, torch.float32)
        self.order = put(order, torch.int32)
        self.block_max_norm = put(block_max_norm, torch.float32)
        self.super_max_norm = put(super_max_norm, torch.float32)
        M_pad = self.T_sorted.shape[0]
        span = self.block_m * self.superblock
        if M_pad % span:
            raise ValueError(f"T_sorted rows {M_pad} are not a multiple of "
                             f"block_m * superblock = {span}")
        self.n_blocks = M_pad // self.block_m
        self.n_super = M_pad // span
        # head slab (the first superblock) that seeds lb0
        self.head_rows = min(span, M_pad)
        self._head = self.T_sorted[:self.head_rows]
        self._head_valid = torch.arange(self.head_rows, device=dev) \
            < self.num_real

    def _to_catalogue_ids(self, local_idx: torch.Tensor) -> torch.Tensor:
        safe = torch.clamp(local_idx, 0, self.num_real - 1).long()
        return torch.where(local_idx >= 0, self.order[safe],
                           torch.full_like(local_idx, -1))

    def _lower_bound0(self, U: torch.Tensor, k: int) -> torch.Tensor:
        """A-priori per-query lower bound on the final K-th best score.

        The K-th best of the head superblock's REAL rows — fully scored,
        so a certificate, not an estimate. ``NEG_INF`` (pre-screen off,
        still exact) when the head holds fewer than k real rows.
        """
        hs = torch.where(self._head_valid[None, :], U @ self._head.T,
                         torch.tensor(NEG_INF, device=self.device))
        kk = min(k, self.head_rows)
        lb0 = stable_topk(hs, kk)[0][:, kk - 1]
        if kk < k or self.num_real < k:
            lb0 = torch.full_like(lb0, NEG_INF)
        return lb0

    def kernel_args(self, U, k: int, mode: str) -> dict:
        """The :func:`topk_mips` operands for a query batch ``U: [B, R]``
        in ``mode``: per-tile bounds ``||u|| * max_norm(tile)`` and, for
        the two-level modes, each query's live prefix from the lb0
        pre-screen (in tiles or superblocks; the bounds are
        non-increasing, so the live steps are a prefix)."""
        U = torch.atleast_2d(torch.as_tensor(
            U, dtype=torch.float32, device=self.device)).contiguous()
        u_norm = torch.linalg.norm(U, dim=1)
        bounds = (u_norm[:, None] * self.block_max_norm[None, :]).contiguous()
        args = dict(T_sorted=self.T_sorted, U=U, tile_bounds=bounds,
                    live=None, k=int(k), block_m=self.block_m, mode=mode,
                    num_real=self.num_real)
        if mode == "single_level":
            return args
        lb0 = self._lower_bound0(U, k)
        if mode == "two_level_tile":
            # head tiles stay live: lb0's witnesses must reach the merge
            steps = torch.arange(self.n_blocks, device=self.device)
            live = (bounds > lb0[:, None]) | (steps[None, :] < self.superblock)
        elif mode == "two_level_batched":
            live = (u_norm[:, None] * self.super_max_norm[None, :]
                    > lb0[:, None])
            live[:, 0] = True
            args["superblock"] = self.superblock
        else:
            raise ValueError(f"unknown mode {mode!r}")
        args["live"] = live.sum(dim=1).to(torch.int32)
        return args

    def query(self, u, k: int, prescreen: bool = True):
        """Exact top-K of one query ``u: [R]``. Returns (values [k],
        catalogue ids [k], stats [3]). ``prescreen=False`` runs the
        single-level mode (every tile walked, runtime bound test only)."""
        u = torch.as_tensor(u, dtype=torch.float32, device=self.device)
        mode = "two_level_tile" if prescreen else "single_level"
        vals, idx, stats = topk_mips(**self.kernel_args(u[None, :], k, mode))
        return vals[0], self._to_catalogue_ids(idx[0]), stats[0]

    def query_batch(self, U, k: int, prescreen: bool = True):
        """Exact top-K for a query batch ``U: [B, R]`` in ONE kernel launch.

        Returns (values [B, k], catalogue ids [B, k], stats [B, 3]).
        """
        mode = "two_level_batched" if prescreen else "single_level"
        vals, idx, stats = topk_mips(**self.kernel_args(U, k, mode))
        return vals, self._to_catalogue_ids(idx), stats
