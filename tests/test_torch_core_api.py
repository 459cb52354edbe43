"""The flat API of ``repro_torch.core`` against the reference's
``repro.core.__all__``.

Every name the reference exports either imports from ``repro_torch.core``
or stands in one of two lists below: ``NOT_YET_PORTED`` (later slices,
keyed to their ``ROADMAP.md`` queue A item; empty since the sharding
slice) or ``REPLACED`` (the single-query scan stack, which the port
replaced by its batched drivers: one query is the batch of one; and the
jax ``shard_map`` shim, replaced by the port's own deal over a mesh). A
listed name that the port does export fails the test."""

import importlib

import pytest

import repro.core as ref_core
import repro_torch.core as core

NOT_YET_PORTED = {}

# reference name -> the port's counterpart, "module:name"
REPLACED = {
    "ScanState": "repro_torch.core.driver:BatchedScanState",
    "ScanStrategy": "repro_torch.core.driver:BatchedScanStrategy",
    "pruned_block_scan": "repro_torch.core.driver:batched_pruned_scan",
    "blocked_lists_strategy": "repro_torch.core.blocked:_batched_list_tail",
    # one list depth a step: the gather tail at block 1
    "ta_round_strategy": "repro_torch.core.blocked:_batched_list_tail",
    "list_prefix_strategy":
        "repro_torch.core.strategies:batched_list_prefix_strategy",
    "norm_block_strategy":
        "repro_torch.core.blocked:norm_pruned_topk_batched",
    # the jax shard_map shim: the port deals arrays over its own mesh
    "compat_shard_map": "repro_torch.core.mesh:shard_array",
}


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def test_lists_are_disjoint_and_name_only_reference_exports():
    ref = set(ref_core.__all__)
    assert not set(NOT_YET_PORTED) & set(REPLACED)
    assert set(NOT_YET_PORTED) <= ref
    assert set(REPLACED) <= ref
    assert set(core.__all__) <= ref, "the port exports names the " \
        "reference lacks"
    assert len(core.__all__) == len(set(core.__all__))


@pytest.mark.parametrize("name", sorted(ref_core.__all__))
def test_reference_name_is_exported_or_listed(name):
    exported = name in core.__all__
    listed = name in NOT_YET_PORTED or name in REPLACED
    assert exported != listed, (
        f"{name}: exported={exported}, listed={listed} -- export it, or "
        "list it, not both")
    if exported:
        assert hasattr(core, name)
    else:
        assert not hasattr(core, name), f"{name} is listed but exported"
    if name in REPLACED:
        assert callable(_resolve(REPLACED[name]))


@pytest.mark.parametrize("name", sorted(core.__all__))
def test_exported_name_is_its_defining_modules_object(name):
    obj = getattr(core, name)
    owner = getattr(obj, "__module__", None)
    if owner is None or not owner.startswith("repro_torch.core."):
        # a constant: find the port module that defines it
        owners = [m for m in ("blocked", "driver", "engines", "index",
                              "layout", "lsm", "naive", "segments",
                              "seplr", "sharded", "strategies",
                              "threshold")
                  if name in vars(importlib.import_module(
                      f"repro_torch.core.{m}"))]
        assert owners, f"{name} is defined in no port core module"
        owner = f"repro_torch.core.{owners[0]}"
    assert getattr(importlib.import_module(owner), name) is obj


def test_flat_import_of_the_main_names():
    from repro_torch.core import (CostTable, SepLRModel, blocked_topk,
                                  build_index, get_engine, naive_topk)
    assert get_engine("bta").name == "bta"
    assert all(callable(f) for f in (SepLRModel, blocked_topk, build_index,
                                     naive_topk, CostTable))


def test_obs_exports_the_references_names():
    import repro.obs as ref_obs
    import repro_torch.obs as obs
    assert obs.__all__ == ref_obs.__all__
