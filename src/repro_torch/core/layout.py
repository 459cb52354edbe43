"""Catalogue layouts: how the catalogue is materialised in memory.

Every engine declares the layout it consumes (``Engine.layout``) and
:class:`repro_torch.core.engines.EngineContext` builds and caches it
lazily. This slice carries the two single-host layouts of the main path:

``row_major``
    The catalogue as given — the naive engine's layout.

``norm_major``
    The decreasing-L2-norm permutation (``targets_by_norm``): a norm
    block is a contiguous ``[block, R]`` slice — the kernel's tile layout,
    shared with the ``norm`` scan.

Pad-row convention for arrays padded to an M-bucket: pad TARGET rows are
zero, pad NORM entries are ``0`` and pad ids ``-1``, so pads sort last
and the real norm-order prefix is untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.index import to_host


@dataclasses.dataclass(frozen=True)
class RowMajorLayout:
    """The catalogue exactly as given; scoring a block is a row gather."""

    targets: torch.Tensor

    name = "row_major"


@dataclasses.dataclass(frozen=True)
class NormMajorLayout:
    """Decreasing-norm permutation: a norm block is a contiguous slice."""

    norm_order: torch.Tensor       # [M] int32 — item ids by decreasing norm
    norms_sorted: torch.Tensor     # [M] — norms in that order
    targets_by_norm: torch.Tensor  # [M, R] — catalogue in that order

    name = "norm_major"


def pad_zero_rows(arr: torch.Tensor, m_bucket: int) -> torch.Tensor:
    """Pad a catalogue-shaped tensor (leading axis M) to ``m_bucket`` rows
    of zeros; no-op when already at the bucket."""
    m = arr.shape[0]
    if m_bucket <= m:
        return arr
    pad = torch.zeros((m_bucket - m,) + tuple(arr.shape[1:]),
                      dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=0)


def build_row_major(targets, index=None, device=None, **_) -> RowMajorLayout:
    return RowMajorLayout(targets=torch.as_tensor(
        targets, dtype=torch.float32, device=resolve_device(device)))


def build_norm_major(targets, index=None, device=None,
                     **_) -> NormMajorLayout:
    """Norm-major layout; reuses the index's norm arrays when available."""
    if index is not None:
        return NormMajorLayout(
            norm_order=index.norm_order,
            norms_sorted=index.norms_sorted,
            targets_by_norm=index.targets_by_norm)
    dev = resolve_device(device)
    T_np = to_host(targets).astype(np.float32)
    norms = np.linalg.norm(T_np, axis=1)
    order = np.argsort(-norms, kind="stable").astype(np.int32)
    return NormMajorLayout(
        norm_order=torch.from_numpy(order).to(dev),
        norms_sorted=torch.from_numpy(norms[order].astype(np.float32)).to(dev),
        targets_by_norm=torch.from_numpy(
            np.ascontiguousarray(T_np[order])).to(dev))


_BUILDERS = {
    "row_major": build_row_major,
    "norm_major": build_norm_major,
}


def layout_names():
    return sorted(_BUILDERS)


def build_layout(name: str, targets, index=None, **params):
    """Name-keyed layout construction (the registry's single entry point)."""
    if name not in _BUILDERS:
        raise ValueError(
            f"unknown layout {name!r}; known: {layout_names()}")
    return _BUILDERS[name](targets, index, **params)
