"""Shared model plumbing: activations, init, norms, MLPs.

Parameters are plain nested dicts and lists of tensors, as the reference's
pytrees are, so that :mod:`repro_torch.convert` carries them across leaf
for leaf. A dense layer's weight ``w`` is
``[in, out]`` and applies as ``x @ w``, as in the reference.

Sharding is expressed through *logical axis names* (:class:`MeshRules`)
resolved against a :class:`repro_torch.core.mesh.Mesh` that the caller
passes explicitly (the reference reads the ambient mesh; ``mesh=None``
here means what no ambient mesh means there). Logical axes (DESIGN.md §5):

* ``"dp"`` — batch / data parallel (mesh: ``("pod", "data")``);
* ``"tp"`` — tensor / expert parallel and the vocab shard (``"model"``);
* ``"fsdp"`` — parameter FSDP shard (``"data"``);
* ``"sp"`` — sequence parallel for the residual stream (``"model"``).

The reference's ``shard(x, rules, *logical)`` is a layout constraint
(``with_sharding_constraint``) that changes no value; one process drives
every shard of a port mesh and the code that shards (the expert-parallel
MoE, the vocab-sharded head) deals its operands itself, so it has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

PyTree = Any


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names to mesh axis names (or None = replicate)."""

    dp: Union[str, Tuple[str, ...], None] = ("pod", "data")
    tp: Optional[str] = "model"
    fsdp: Optional[str] = "data"
    sp: Optional[str] = "model"

    def resolve(self, *logical: Optional[str], mesh=None) -> tuple:
        """The partition spec of ``logical`` names on ``mesh``, one entry
        a dimension (the form :func:`repro_torch.core.mesh.shard_array`
        reads): ``()`` without a mesh; an axis missing from the mesh
        replicates."""
        if mesh is None:
            return ()
        names = set(mesh.axis_names)

        def r(ax):
            if ax is None:
                return None
            got = getattr(self, ax)
            if got is None:
                return None
            if isinstance(got, tuple):
                return spec_entry(tuple(g for g in got if g in names))
            return got if got in names else None

        return tuple(r(ax) for ax in logical)

    def dp_axes(self, mesh) -> Tuple[str, ...]:
        """The data-parallel axes that ``mesh`` has, in rule order."""
        dp = self.dp if isinstance(self.dp, tuple) else (self.dp,)
        return tuple(a for a in dp if a in mesh.axis_names)


def spec_entry(axes: Tuple[str, ...]):
    """A spec entry for ``axes``, as ``PartitionSpec`` normalises it:
    ``None`` for none, the name for one, the tuple for several."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# Single-pod rules drop the "pod" axis automatically via resolve().
DEFAULT_RULES = MeshRules()

# jax.nn.gelu defaults to the tanh approximation, so both names map to it.
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def dense_init(generator: torch.Generator, shape,
               device=None) -> torch.Tensor:
    """LeCun-normal (fan-in, the second-to-last axis) init in fp32, drawn
    from ``generator`` on ``device`` (default: the generator's; ``meta``
    gives a stand-in that allocates nothing), scaled in place: a
    full-width expert stack is 8.6 GB."""
    return torch.randn(tuple(shape), generator=generator,
                       device=device or generator.device,
                       dtype=torch.float32).div_(math.sqrt(shape[-2]))


def embed_init(generator: torch.Generator, shape, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """Standard-normal embedding table in fp32 times ``scale``, drawn from
    ``generator`` on ``device`` (default: the generator's)."""
    return torch.randn(tuple(shape), generator=generator,
                       device=device or generator.device,
                       dtype=torch.float32) * scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in fp32 and cast back to
    ``x``'s dtype; the learned scale enters as ``1 + scale``."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def count_params(params: PyTree) -> int:
    """Number of scalars in a nested dict/list/tuple of tensors."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0


def cast_tree(params: PyTree, dtype: torch.dtype) -> PyTree:
    """The same tree with every floating-point tensor cast to ``dtype``
    (a tensor already of ``dtype`` is kept, not copied)."""
    if isinstance(params, torch.Tensor):
        return params.to(dtype) if params.is_floating_point() else params
    if isinstance(params, dict):
        return {key: cast_tree(v, dtype) for key, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_tree(v, dtype) for v in params)
    return params


def mlp_params(generator: torch.Generator, dims: Sequence[int],
               device=None):
    """Plain MLP parameter stack on ``device`` (default: the generator's):
    ``[{"w": [in, out], "b": [out]}, ...]``."""
    dev = device or generator.device
    return [{"w": dense_init(generator, (dims[i], dims[i + 1]), dev),
             "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=dev)}
            for i in range(len(dims) - 1)]


def mlp_apply(layers, x: torch.Tensor, act: str = "relu",
              final_act: bool = False) -> torch.Tensor:
    fn = ACTIVATIONS[act]
    n = len(layers)
    for i, p in enumerate(layers):
        x = x @ p["w"].to(x.dtype)
        if "b" in p:
            x = x + p["b"].to(x.dtype)
        if i + 1 < n or final_act:
            x = fn(x)
    return x
