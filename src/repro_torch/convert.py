"""State carried across from the reference package.

:func:`from_reference` turns the reference's arrays, handed over as numpy
(the port never imports ``jax`` or ``repro``), into the port's objects on
a chosen device, so that both packages compute over the identical state:

* ``{"targets"}`` (a ``SepLRModel``) -> :class:`SepLRModel`
* the six :class:`TopKIndex` fields -> :class:`TopKIndex`
* ``{"T_sorted", "order", "block_max_norm", "super_max_norm", "num_real",
  "block_m", "superblock"}`` (a ``MIPSCatalog``) -> :class:`MIPSCatalog`
* the eight :class:`ListMajorLayout` fields (the six prefix tiles, any of
  them ``None`` for a single-sided layout, ``rank_by_item`` and
  ``prefix_depth``) -> :class:`ListMajorLayout`

:func:`params_from_reference` (also named
``recsys_params_from_reference`` and ``transformer_params_from_reference``)
carries the reference's model parameters across as the same tree of
tensors: the recsys trees (``repro.models.recsys.init_params``: a nested
dict of arrays with MLP lists of ``{"w", "b"}``) and the LM's
(``repro.models.transformer.init_params``: ``embed``, ``final_norm``,
``unembed`` and the ``[L, ...]`` layer stack, a MoE config's
``router``/``moe_gate``/``moe_up``/``moe_down`` included), and the
reference's ``MoEParams`` (``repro.models.moe.init_moe``), which comes
across as the port's :class:`repro_torch.models.moe.MoEParams`. Dense
weights keep the reference's ``[in, out]`` layout (the port applies them
as ``x @ w`` too), so nothing is transposed.
:func:`opt_state_from_reference` carries the reference's optimizer state
across, so both packages can train on from one state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.index import TopKIndex
from repro_torch.core.layout import ListMajorLayout
from repro_torch.core.seplr import SepLRModel
from repro_torch.kernels.ops import MIPSCatalog
from repro_torch.models.moe import MoEParams
from repro_torch.train.optimizer import OptState

MODEL_FIELDS = frozenset({"targets"})
INDEX_FIELDS = frozenset(f.name for f in dataclasses.fields(TopKIndex))
CATALOG_FIELDS = frozenset({"T_sorted", "order", "block_max_norm",
                            "super_max_norm", "num_real", "block_m",
                            "superblock"})

LIST_FIELDS = frozenset(f.name for f in dataclasses.fields(ListMajorLayout))

_INT_FIELDS = {"order_desc", "rank_desc", "norm_order", "head_ids",
               "tail_ids", "head_ranks", "tail_ranks", "rank_by_item"}


def _put(arrays, f, dev):
    dt = np.int32 if f in _INT_FIELDS else np.float32
    return torch.tensor(np.asarray(arrays[f], dt), device=dev)


def from_reference(arrays: Mapping[str, Any], device=None, name=None):
    """The port's object for the reference state in ``arrays`` (a mapping
    from the reference's field names to numpy arrays or ints), on
    ``device`` (``None`` = ``cuda``). The key set names the object."""
    dev = resolve_device(device)
    keys = frozenset(arrays)
    if keys == MODEL_FIELDS:
        return SepLRModel(np.array(arrays["targets"], np.float32),
                          name=name or "seplr", device=dev)
    if keys == INDEX_FIELDS:
        return TopKIndex(**{f: _put(arrays, f, dev)
                            for f in sorted(INDEX_FIELDS)})
    if keys == LIST_FIELDS:
        return ListMajorLayout(
            prefix_depth=int(arrays["prefix_depth"]),
            **{f: None if arrays[f] is None else _put(arrays, f, dev)
               for f in sorted(LIST_FIELDS - {"prefix_depth"})})
    if keys == CATALOG_FIELDS:
        return MIPSCatalog.from_state(
            np.asarray(arrays["T_sorted"], np.float32),
            np.asarray(arrays["order"], np.int32),
            np.asarray(arrays["block_max_norm"], np.float32),
            np.asarray(arrays["super_max_norm"], np.float32),
            int(arrays["num_real"]), int(arrays["block_m"]),
            int(arrays["superblock"]), device=dev)
    raise ValueError(
        f"unrecognised reference state with fields {sorted(keys)}; expected "
        f"{sorted(MODEL_FIELDS)}, {sorted(INDEX_FIELDS)}, "
        f"{sorted(CATALOG_FIELDS)} or {sorted(LIST_FIELDS)}")


def params_from_reference(params: Any, device=None) -> Any:
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays: the recsys trees, or the LM's with its layers stacked
    ``[L, ...]``; or a ``MoEParams``) as the same tree of float32 tensors
    on ``device``
    (``None`` = ``cuda``). A tree the reference cast to bf16 comes across
    with the same values in float32."""
    return _params_to(params, resolve_device(device))


# the names each model family's callers use
recsys_params_from_reference = params_from_reference
transformer_params_from_reference = params_from_reference


def opt_state_from_reference(state: Any, device=None) -> OptState:
    """The reference's optimizer state (``repro.train.optimizer.OptState``:
    ``step``, then the ``mu`` and ``nu`` trees, as numpy arrays) as the
    port's :class:`repro_torch.train.optimizer.OptState` on ``device``
    (``None`` = ``cuda``): the step a 0-d int32 tensor, the moments float32
    trees of the parameters' structure (Adagrad's and SGD's ``nu`` 0-d
    leaves)."""
    step, mu, nu = state
    dev = resolve_device(device)
    return OptState(torch.tensor(np.asarray(step, np.int32), device=dev),
                    _params_to(mu, dev), _params_to(nu, dev))


def _params_to(node: Any, dev: torch.device) -> Any:
    if isinstance(node, Mapping):
        return {key: _params_to(v, dev) for key, v in node.items()}
    if getattr(node, "_fields", None) == MoEParams._fields:
        return MoEParams(*(_params_to(v, dev) for v in node))
    if isinstance(node, (list, tuple)):
        return [_params_to(v, dev) for v in node]
    return torch.tensor(np.asarray(node, np.float32), device=dev)
