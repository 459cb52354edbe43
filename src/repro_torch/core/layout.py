"""Catalogue layouts: how the catalogue is materialised in memory.

Every engine declares the layout it consumes (``Engine.layout``) and
:class:`repro_torch.core.engines.EngineContext` builds and caches it
lazily. Three single-host layouts and one sharded layout:

``row_major``
    The catalogue as given — the naive engine's layout.

``norm_major``
    The decreasing-L2-norm permutation (``targets_by_norm``): a norm
    block is a contiguous ``[block, R]`` slice — the kernel's tile layout,
    shared with the ``norm`` scan.

``list_major``
    Per-dimension list PREFIXES materialised contiguously (the rows, ids
    and all-list ranks of the first ``prefix_depth`` entries of every
    sorted list, for the descending walk and the ascending walk a
    negative query weight takes), plus ``rank_by_item [M, R]``. Inside
    the prefix a Block Threshold Algorithm step reads contiguous tiles;
    past it the scan gathers rows and ranks of its candidates.

``norm_sharded``
    The norm-major layout dealt round-robin over ``n_shards`` shards
    (global norm rank i lives on shard ``i % n`` at local position
    ``i // n``), so every shard's local norm spectrum mirrors the global
    one. Consumed by the ``norm_sharded`` engine
    (:func:`repro_torch.core.sharded.sharded_norm_topk`).

Pad-row convention for arrays padded to an M-bucket: pad TARGET rows are
zero, pad NORM entries are ``0`` and pad ids ``-1``, so pads sort last
and the real norm-order prefix is untouched. The list engines run on the
real M: nothing of ``list_major`` is padded. ``norm_sharded`` pads the
global item count to ``m_total`` (the M-bucket, from the engine) before
the deal: unlike the list engines' padding, this one sets each slab's
length, and so the block and the bound at a slab's last real block, and
with them the counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.index import to_host
from repro_torch.core.mesh import shard_array

#: Default list-prefix depth (rows per dimension), the reference's
#: calibration on its benchmark catalogues. Deeper scans continue in the
#: gather tail (at LSHTC-like R = 100 most do: PERF.md).
DEFAULT_PREFIX_DEPTH = 2048

#: Smallest catalogue for which the list_major layout is on BY DEFAULT;
#: below it the gather path serves the list engines. An explicit
#: ``EngineContext(prefix_depth=...)`` overrides it.
LIST_LAYOUT_MIN_TARGETS = 32768


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


@dataclasses.dataclass(frozen=True)
class ListMajorLayout:
    """Contiguous list prefixes for the gather-free list scan.

    Attributes:
      head_rows: ``[R, P, R]`` — ``targets[order_desc[r, p]]`` for
        ``p < P``: the DESCENDING walk's prefix, contiguous per dimension.
      tail_rows: ``[R, P, R]`` — the ASCENDING walk's prefix
        (``targets[order_desc[r, M-1-p]]``), what a negative query weight
        reads.
      head_ids / tail_ids: ``[R, P]`` int32 — the walk-order item ids.
      head_ranks / tail_ranks: ``[R, P, R]`` int32 — each prefix item's
        positions in ALL lists (``rank_by_item[ids]``), in walk order:
        freshness inside the prefix is a slice and a min.
      rank_by_item: ``[M, R]`` int32 — ``rank_desc`` transposed, so one
        item's positions in all lists are a contiguous row (the freshness
        gather past the prefix).
      prefix_depth: P.

    Either direction's tiles may be ``None`` (:meth:`sided`, or
    ``build_list_major(sides=...)``): a single-sided layout serves the
    matching sign bucket from its prefix, and the engine serves the other
    buckets by the gather path. ``rank_by_item`` is always present.
    """

    head_rows: Optional[torch.Tensor]
    tail_rows: Optional[torch.Tensor]
    head_ids: Optional[torch.Tensor]
    tail_ids: Optional[torch.Tensor]
    head_ranks: Optional[torch.Tensor]
    tail_ranks: Optional[torch.Tensor]
    rank_by_item: torch.Tensor
    prefix_depth: int

    name = "list_major"

    def prefix_steps(self, block_size: int) -> int:
        """Whole blocks of ``block_size`` covered by the prefix."""
        return self.prefix_depth // max(block_size, 1)

    @property
    def sides(self) -> tuple:
        """The prefix directions this layout materialised."""
        out = ()
        if self.head_rows is not None:
            out += ("head",)
        if self.tail_rows is not None:
            out += ("tail",)
        return out

    @property
    def two_sided(self) -> bool:
        return self.head_rows is not None and self.tail_rows is not None

    def serves_sign(self, sign: int) -> bool:
        """Can the prefix serve a batch of this sign bucket? (``0`` —
        mixed — needs both directions.)"""
        if sign > 0:
            return self.head_rows is not None
        if sign < 0:
            return self.tail_rows is not None
        return self.two_sided

    def sided(self, side: str) -> "ListMajorLayout":
        """Drop the other direction's tiles (halve the prefix footprint)."""
        if side not in ("head", "tail"):
            raise ValueError(f"side must be 'head' or 'tail', got {side!r}")
        drop = dict.fromkeys(
            ("tail_rows", "tail_ids", "tail_ranks") if side == "head"
            else ("head_rows", "head_ids", "head_ranks"))
        return dataclasses.replace(self, **drop)


@dataclasses.dataclass(frozen=True)
class ShardedNormLayout:
    """Round-robin-dealt norm-major layout.

    The arrays are shard-major: rows ``[s*m_local, (s+1)*m_local)`` are
    shard s's slab, itself in decreasing-norm order (a strided deal of the
    global norm order). Slabs are padded to equal length with zero rows of
    norm 0 and id -1, a suffix of each slab. Built with a mesh, each
    field is a :class:`repro_torch.core.mesh.ShardedArray` whose slabs
    lie on their shards' devices (``np.asarray`` gives the whole array);
    without one, a tensor.
    """

    targets_sharded: object  # [n*m_local, R]
    norms_sharded: object    # [n*m_local]
    ids_sharded: object      # [n*m_local] int32; -1 marks padding
    n_shards: int

    name = "norm_sharded"


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


def build_list_major(targets, index, prefix_depth: Optional[int] = None,
                     sides: tuple = ("head", "tail"), device=None,
                     **_) -> ListMajorLayout:
    """Materialise the list prefixes from the sorted-list ``index``, on
    the index's device (an ``O(R * P * R)`` copy; ``prefix_depth`` is
    clamped to ``[1, M]``). ``sides`` selects the walk directions that get
    prefix tiles."""
    if not sides or any(s not in ("head", "tail") for s in sides):
        raise ValueError(f"sides must be a non-empty subset of "
                         f"('head', 'tail'), got {sides!r}")
    if index is None:
        raise ValueError("list_major is built from the sorted-list index")
    od = index.order_desc                                    # [R, M]
    R, M = od.shape
    T = torch.as_tensor(targets, dtype=torch.float32, device=od.device)
    P = max(int(min(M, DEFAULT_PREFIX_DEPTH if prefix_depth is None
                    else prefix_depth)), 1)
    rank_by_item = index.rank_desc.T.contiguous()            # [M, R]

    def _side(ids):
        ids = ids.contiguous()
        rows = ids.long()
        return T[rows], ids, rank_by_item[rows]

    none = (None, None, None)
    head = _side(od[:, :P]) if "head" in sides else none
    tail = _side(od.flip(1)[:, :P]) if "tail" in sides else none
    return ListMajorLayout(
        head_rows=head[0], head_ids=head[1], head_ranks=head[2],
        tail_rows=tail[0], tail_ids=tail[1], tail_ranks=tail[2],
        rank_by_item=rank_by_item, prefix_depth=P)


def build_norm_sharded(targets, index, n_shards: int, mesh=None,
                       axis_name: str = "data",
                       m_total: Optional[int] = None, device=None,
                       **_) -> ShardedNormLayout:
    """Deal the norm order round-robin over ``n_shards`` equal slabs of
    ``ceil(max(M, m_total) / n_shards)`` rows: global norm rank i goes to
    shard ``i % n`` at position ``i // n`` (:func:`round_robin_shares`'
    deal), the rest of each slab padding. The deal runs on the index's
    device (else ``device``). With ``mesh``, each slab is placed on its
    shard's device along ``axis_name``
    (:func:`repro_torch.core.mesh.shard_array`)."""
    if index is not None:
        order = index.norm_order
        norms = index.norms_sorted
        T = torch.as_tensor(targets, dtype=torch.float32, device=order.device)
    else:
        T = torch.as_tensor(targets, dtype=torch.float32,
                            device=resolve_device(device))
        n = torch.linalg.norm(T, dim=1)
        order = torch.from_numpy(np.argsort(-to_host(n), kind="stable")
                                 .astype(np.int32)).to(T.device)
        norms = n[order.long()]
    M, R = T.shape
    m_local = -(-max(M, m_total or M) // n_shards)
    pad = n_shards * m_local - M
    # padded rank j sits at [j // n, j % n]: the transpose is shard-major
    ids = torch.cat([order.to(torch.int32), order.new_full((pad,), -1,
                                                            dtype=torch.int32)])
    ids = ids.reshape(m_local, n_shards).T.reshape(-1).contiguous()
    norms_sh = torch.cat([norms, norms.new_zeros(pad)]).reshape(
        m_local, n_shards).T.reshape(-1).contiguous()
    real = ids >= 0
    T_sh = torch.where(real[:, None], T[torch.clamp(ids, min=0).long()],
                       torch.zeros((), dtype=T.dtype, device=T.device))
    arrays = (T_sh, norms_sh, ids)
    if mesh is not None:
        arrays = (shard_array(T_sh, mesh, (axis_name, None)),
                  shard_array(norms_sh, mesh, (axis_name,)),
                  shard_array(ids, mesh, (axis_name,)))
    return ShardedNormLayout(targets_sharded=arrays[0],
                             norms_sharded=arrays[1],
                             ids_sharded=arrays[2], n_shards=n_shards)


def round_robin_shares(n: int, n_shards: int, start: int = 0) -> np.ndarray:
    """Rows each shard receives when ``n`` items are dealt round-robin
    starting at cursor position ``start`` — the strided deal of the
    reference's sharded norm layout, used by the LSM catalogue's L0 -> L1
    fold (the fit check and the deal itself). Returns ``[n_shards]
    int64``.
    """
    shares = np.full((n_shards,), n // n_shards, np.int64)
    for i in range(n % n_shards):
        shares[(start + i) % n_shards] += 1
    return shares


_BUILDERS = {
    "row_major": build_row_major,
    "norm_major": build_norm_major,
    "list_major": build_list_major,
    "norm_sharded": build_norm_sharded,
}


def layout_names():
    return sorted(_BUILDERS)


def build_layout(name: str, targets, index=None, **params):
    """Name-keyed layout construction (the registry's single entry point)."""
    if name not in _BUILDERS:
        raise ValueError(
            f"unknown layout {name!r}; known: {layout_names()}")
    return _BUILDERS[name](targets, index, **params)
