"""Sorted-list index and norm-order metadata.

The paper's algorithms consume R sorted lists L_1..L_R, where L_r orders
the catalogue by t_r(y) descending; a negative query weight walks list r
ascending instead. On top of the lists the index keeps the norm order
used by the norm-block scan: items permuted by decreasing L2 norm, so
that the Cauchy-Schwarz bound ``s(x, y) <= ||u|| * max_norm(block)``
prunes whole contiguous blocks.

The index is built offline on the host with numpy — the same stable
argsorts as the reference, so both packages agree id for id, ties
included — and then moved to ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class TopKIndex:
    """Pre-sorted per-dimension lists plus norm-block metadata.

    Attributes:
      order_desc: ``[R, M]`` int32 — item ids sorted by t_r descending.
      t_sorted_desc: ``[R, M]`` — ``T[order_desc[r], r]``.
      rank_desc: ``[R, M]`` int32 — inverse permutations of ``order_desc``.
      norm_order: ``[M]`` int32 — item ids by decreasing L2 norm.
      norms_sorted: ``[M]`` — norms in that order.
      targets_by_norm: ``[M, R]`` — the catalogue permuted into
        decreasing-norm order (a norm block is a contiguous slice).
    """

    order_desc: torch.Tensor
    t_sorted_desc: torch.Tensor
    rank_desc: torch.Tensor
    norm_order: torch.Tensor
    norms_sorted: torch.Tensor
    targets_by_norm: torch.Tensor

    @property
    def num_targets(self) -> int:
        return int(self.order_desc.shape[1])

    @property
    def rank(self) -> int:
        return int(self.order_desc.shape[0])


def to_host(x) -> np.ndarray:
    """numpy view of a host array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_index(T, device=None) -> TopKIndex:
    """Build the sorted-list index (offline, ``O(R M log M)``) on the host
    and move it to ``device`` (``None`` = ``cuda``)."""
    dev = resolve_device(device)
    T_np = to_host(T)
    M, R = T_np.shape
    # stable descending sort; ties broken by lower item id first (the
    # paper's Table 1 list convention)
    order_desc = np.argsort(-T_np, axis=0, kind="stable").T.astype(np.int32)
    t_sorted_desc = np.take_along_axis(T_np.T, order_desc, axis=1)
    rank_desc = np.empty_like(order_desc)
    np.put_along_axis(rank_desc, order_desc,
                      np.broadcast_to(np.arange(M, dtype=np.int32), (R, M)),
                      axis=1)
    norms = np.linalg.norm(T_np, axis=1)
    norm_order = np.argsort(-norms, kind="stable").astype(np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return TopKIndex(
        order_desc=put(order_desc),
        t_sorted_desc=put(t_sorted_desc.astype(np.float32)),
        rank_desc=put(rank_desc),
        norm_order=put(norm_order),
        norms_sorted=put(norms[norm_order].astype(np.float32)),
        targets_by_norm=put(T_np[norm_order].astype(np.float32)),
    )
