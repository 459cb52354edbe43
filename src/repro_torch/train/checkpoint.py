"""Fault-tolerant checkpoints: atomic, asynchronous, keep-last-N, in the
reference's on-disk format.

Format: ``step_%010d/arrays.npz`` (uncompressed) holding every leaf under
its ``"|"``-joined tree path (:func:`repro_torch.train.tree.path_key`:
``params|embed``, ``params|deep|0|w``, ``opt|.mu|embed``, ``opt|.step``),
plus ``manifest.json`` (``step``, ``time``, ``leaves``, ``nbytes``,
``extra``). The leaf keys and arrays are the reference's, so a checkpoint
crosses between the packages in both directions. Writes go to a
``.tmp`` directory, then an atomic ``os.replace``: a process killed
mid-save never corrupts the latest valid checkpoint. ``save`` copies
every leaf to host memory before it returns (the next step may update the
tensors in place), then writes on a thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.mesh import shard_array
from repro_torch.train.tree import (path_key, subtree, tree_flatten_with_path,
                                    tree_unflatten)

PyTree = Any


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot touch."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {path_key(path): _host(leaf)
            for path, leaf in tree_flatten_with_path(tree)}


def _place(arr: np.ndarray, leaf, layout, path):
    """``arr`` as a tensor on ``leaf``'s device; with a ``(mesh, specs)``
    layout, a leaf whose spec splits a dimension is dealt over the mesh
    (:func:`repro_torch.core.mesh.shard_array`) and any other goes to the
    mesh's first device."""
    x = torch.from_numpy(arr)
    if layout is not None:
        mesh, specs = layout
        spec = subtree(specs, path)
        if any(e is not None for e in spec):
            return shard_array(x, mesh, spec)
        return x.to(mesh.devices.flat[0])
    return x.to(leaf.device) if isinstance(leaf, torch.Tensor) else x


def _unflatten_into(template: PyTree, arrays: Dict[str, np.ndarray],
                    layout=None) -> PyTree:
    leaves = []
    for path, leaf in tree_flatten_with_path(template):
        key = path_key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                             f"template {tuple(leaf.shape)}")
        leaves.append(_place(arr, leaf, layout, path))
    return tree_unflatten(template, leaves)


class CheckpointManager:
    """keep-last-N atomic checkpoints with an optional asynchronous writer."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def list_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                manifest = os.path.join(self.directory, name, "manifest.json")
                if os.path.exists(manifest):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        """Snapshot to host memory now; write to disk (asynchronously by
        default)."""
        arrays = _flatten(tree)  # device -> host copies, synchronously
        self.wait()              # never two writers at once

        def _write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {
                "step": step,
                "time": time.time(),
                "leaves": sorted(arrays.keys()),
                "nbytes": int(sum(a.nbytes for a in arrays.values())),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def restore(self, template: PyTree, step: Optional[int] = None,
                shardings=None):
        """Load into the template's structure, each leaf a tensor on the
        template leaf's device (the saved dtype). ``shardings``, the
        reference's elastic resume onto another mesh, is a ``core/mesh.py``
        layout here: ``(mesh, specs)`` with ``specs`` a tree of partition
        specs in the template's structure (``param_specs``' form), each
        split leaf dealt over ``mesh``. Returns ``(tree, step)``, or
        ``(None, None)`` when there is no checkpoint."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        path = self._step_dir(step)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
        return _unflatten_into(template, arrays, shardings), step
