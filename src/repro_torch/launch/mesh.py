"""The reference's production and test meshes, as port meshes.

Functions, not module-level meshes: importing this module touches no
device. Each mesh is :func:`repro_torch.core.mesh.make_mesh` over one
device repeated (``"single"`` is 256 logical shards of it). ``device=None``
means ``cuda`` and raises without a card; the dry run passes ``"meta"``
(shapes only, nothing allocated), the CPU tests ``"cpu"``.
"""

from __future__ import annotations

import math

from repro_torch import resolve_device
from repro_torch.core.mesh import Mesh, make_mesh


def _mk(shape, axes, device) -> Mesh:
    dev = resolve_device(device)
    return make_mesh(shape, axes, [dev] * math.prod(shape))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_tiny_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Scaled-down mesh for the integration tests (8 logical shards)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


MESHES = {
    "single": lambda device=None: make_production_mesh(multi_pod=False,
                                                       device=device),
    "multi": lambda device=None: make_production_mesh(multi_pod=True,
                                                      device=device),
    "tiny": lambda device=None: make_tiny_mesh(multi_pod=False,
                                               device=device),
    "tiny-multi": lambda device=None: make_tiny_mesh(multi_pod=True,
                                                     device=device),
}
