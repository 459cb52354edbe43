"""Gradient compression for the cross-pod all-reduce.

int8 linear quantisation (no stochastic rounding) with **error feedback**
(EF-SGD, Seide et al. / Karimireddy et al.): the quantisation residual is
carried to the next step so compression bias does not accumulate. It
cuts the all-reduce's bytes 4x for fp32 at equal step count.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payloads are the reference's.

The reference's ``compressed_psum`` runs inside ``shard_map`` and sums
over a mesh axis with ``psum``. Here one process drives every shard
(:mod:`repro_torch.core.mesh`), so the shards' tensors come stacked on a
leading shard dimension and the ``psum`` is a sum over it, each shard's
contribution dequantised with its own scale.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.mesh import Mesh, ShardedArray, shard_array
from repro_torch.train.tree import tree_leaves, tree_unflatten

PyTree = Any


def _quantize_shards(x: torch.Tensor):
    """:func:`quantize_int8` of each ``x[s]`` of a stack ``[S, ...]``, each
    with its own scale: ``(q [S, ...], scale [S, 1, ...])``."""
    peak = torch.abs(x).reshape(x.shape[0], -1).amax(1)
    scale = peak.reshape((-1,) + (1,) * (x.dim() - 1)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    q, scale = _quantize_shards(x[None])
    return q[0], scale.reshape(())


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ef_compress_shards(grad: torch.Tensor, error: torch.Tensor):
    """:func:`ef_compress` of each shard of ``[S, ...]`` stacks, each with
    its own scale: ``(q [S, ...], scale [S, 1, ...], new_error [S, ...])``."""
    target = grad + error
    q, scale = _quantize_shards(target)
    return q, scale, target - dequantize_int8(q, scale)


def ef_compress(grad: torch.Tensor, error: torch.Tensor):
    """Error-feedback compression of one tensor.

    Returns ``(q int8, scale, new_error)``, ``new_error = (g + e) -
    dequant(q)``."""
    q, scale, new_error = _ef_compress_shards(grad[None], error[None])
    return q[0], scale.reshape(()), new_error[0]


def compressed_psum(grad: torch.Tensor, error: torch.Tensor):
    """int8 all-reduce with error feedback over the shards stacked on
    ``grad``'s and ``error``'s leading dimension ``[S, ...]``: the mean of
    the shards' dequantised gradients ``[...]``, and each shard's new error
    ``[S, ...]``."""
    q, scale, new_error = _ef_compress_shards(grad, error)
    return dequantize_int8(q, scale).sum(0) / grad.shape[0], new_error


def make_compressed_allreduce(mesh: Mesh, axis: str = "pod"):
    """Tree-level wrapper: ``(grads, errors) -> (mean grads, new errors)``.

    Each leaf's leading dimension stacks the per-``axis``-shard partial
    gradients (a multi-pod data-parallel step whose in-pod reduction
    already happened); it is dealt over ``mesh`` along ``axis``
    (:func:`repro_torch.core.mesh.shard_array`), each shard compressed on
    its device, and the int8 payloads and scales summed on the mesh's
    first device. The mean gradients come back on that device, the new
    errors dealt as the gradients were (a ``ShardedArray``, which the next
    call takes as it is)."""

    def one(g, e):
        gs, es = shard_array(g, mesh, (axis,)), shard_array(e, mesh, (axis,))
        dev = gs.groups[0].device
        total, new_parts = 0, []
        for gp, ep in zip(gs.parts, es.parts):
            # a part is [S_g, 1, ...]: its device's shards of the leading dim
            q, scale, ne = _ef_compress_shards(gp[:, 0], ep[:, 0])
            total = total + dequantize_int8(q.to(dev), scale.to(dev)).sum(0)
            new_parts.append(ne[:, None])
        return (total / gs.n_shards,
                ShardedArray(mesh, gs.spec, gs.groups, tuple(new_parts)))

    def fn(grads: PyTree, errors: PyTree):
        outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                          tree_leaves(errors))]
        return (tree_unflatten(grads, [o for o, _ in outs]),
                tree_unflatten(grads, [e for _, e in outs]))

    return fn
