"""The streaming tier through both packages in lockstep.

:class:`Pair` holds the reference's ``SegmentedCatalogue`` (JAX, the
CPU) and the port's (``device="cpu"``: its tail and engines in plain
PyTorch) over the same rows — or, with ``n_shards > 0``, both packages'
``ShardedLsmCatalogue`` — applies every mutation to both, and holds
every query of the port against the reference's: values (1e-5 relative),
ids id for id where scores are distinct and as a multiset per query,
``n_scored``, ``depth`` and every field of ``QueryInfo``. Reads of state
(``num_live``, ``stats``, ...) come from the port's catalogue after the
two states are checked equal. Each package keeps its own fault registry,
so :func:`arm_both` / :func:`injected_both` arm the same point in both.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.core import faults as ref_faults
from repro.core import get_engine as ref_get_engine
from repro.core.lsm import ShardedLsmCatalogue as RefLsm
from repro.core.segments import SegmentedCatalogue as RefCatalogue
from repro_torch.core import faults, get_engine
from repro_torch.core.lsm import ShardedLsmCatalogue
from repro_torch.core.segments import SegmentedCatalogue

from _torch_parity import assert_ids_where_distinct, assert_values, host

#: the port's engine names -> the reference's
REF_NAME = {"topk_mips": "pallas"}

#: SegmentStats fields both packages count alike (wall-clock seconds and
#: compile counts differ by nature: jit traces there, kernel loads here)
COUNTED = ("n_inserts", "n_deletes", "n_updates", "n_compactions",
           "n_failed_compactions", "max_delta_occupancy", "n_build_retries",
           "n_forced_sync_compactions", "n_stuck_builds", "max_l0_chain",
           "n_l1_folds", "n_failed_l1_folds", "n_l1_fold_retries")


def arm_both(point, **kw):
    ref_faults.arm(point, **kw)
    faults.arm(point, **kw)


def disarm_all_both():
    ref_faults.disarm_all()
    faults.disarm_all()


@contextlib.contextmanager
def injected_both(point, **kw):
    with ref_faults.injected(point, **kw), faults.injected(point, **kw):
        yield


def assert_same_result(got, want):
    """Values, ids (id for id where distinct, a multiset per query) and
    the per-query counts of two ``TopKResult``s."""
    assert_values(got.values, want.values)
    assert_ids_where_distinct(got.indices, want.indices, want.values)
    np.testing.assert_array_equal(np.sort(host(got.indices), axis=-1),
                                  np.sort(np.asarray(want.indices), axis=-1))
    np.testing.assert_array_equal(host(got.n_scored),
                                  np.asarray(want.n_scored))
    np.testing.assert_array_equal(host(got.depth), np.asarray(want.depth))


def _same_outcome(ref_call, port_call):
    """Run both calls; both return, or both raise the same type."""
    try:
        want = ref_call()
    except Exception as exc:           # noqa: BLE001 — compared below
        want_exc = exc
    else:
        want_exc = None
    if want_exc is None:
        return want, port_call()
    try:
        port_call()
    except type(want_exc):
        raise want_exc
    raise AssertionError(f"the reference raised {want_exc!r}, the port "
                         "did not")


class Pair:
    """Both packages' catalogues over the same rows (see the module)."""

    def __init__(self, targets, n_shards=0, **kw):
        targets = np.asarray(targets, np.float32)
        if n_shards:
            self.ref = RefLsm(targets, n_shards=n_shards, **kw)
            self.port = ShardedLsmCatalogue(targets, n_shards=n_shards,
                                            device="cpu", **kw)
        else:
            self.ref = RefCatalogue(targets, **kw)
            self.port = SegmentedCatalogue(targets, device="cpu", **kw)

    def __getattr__(self, name):
        return getattr(self.port, name)

    def add_targets(self, rows):
        want, got = _same_outcome(lambda: self.ref.add_targets(rows),
                                  lambda: self.port.add_targets(rows))
        np.testing.assert_array_equal(got, want)
        return got

    def delete_targets(self, gids):
        _same_outcome(lambda: self.ref.delete_targets(gids),
                      lambda: self.port.delete_targets(gids))

    def update_targets(self, gids, rows):
        _same_outcome(lambda: self.ref.update_targets(gids, rows),
                      lambda: self.port.update_targets(gids, rows))

    def compact(self, wait=True):
        _same_outcome(lambda: self.ref.compact(wait=wait),
                      lambda: self.port.compact(wait=wait))

    def promote(self, wait=True):
        _same_outcome(lambda: self.ref.promote(wait=wait),
                      lambda: self.port.promote(wait=wait))

    def flush(self):
        self.ref.flush()
        self.port.flush()

    def query(self, engine, U, k, budget=None, counts=True):
        """The port's ``(result, info)``, held against the reference's.
        ``counts=False`` (a build racing the query in one package and not
        the other) compares only values and ids."""
        U = np.atleast_2d(np.asarray(U, np.float32))
        want, want_info = self.ref.query(
            ref_get_engine(REF_NAME.get(engine, engine)), jnp.asarray(U),
            k, budget=budget)
        got, info = self.port.query(get_engine(engine), U, k, budget=budget)
        if counts:
            assert_same_result(got, want)
            assert dataclasses.astuple(info) == dataclasses.astuple(
                want_info), (info, want_info)
        else:
            assert_values(got.values, want.values)
            assert_ids_where_distinct(got.indices, want.indices, want.values)
        return got, info

    def check_state(self):
        """The visible contents and every counted statistic agree."""
        rows_r, gids_r = self.ref.as_dense()
        rows_p, gids_p = self.port.as_dense()
        np.testing.assert_array_equal(gids_p, gids_r)
        np.testing.assert_array_equal(rows_p, rows_r)
        for name in ("num_live", "n_tombstones", "delta_occupancy",
                     "version", "l0_chain_len", "consecutive_build_failures",
                     "n_shards", "l1_rows", "consecutive_fold_failures",
                     "pristine", "cache_token"):
            got, want = getattr(self.port, name), getattr(self.ref, name)
            if callable(got):
                got, want = got(), want()
            assert got == want, (name, got, want)
        for field in COUNTED:
            assert getattr(self.port.stats, field) == getattr(
                self.ref.stats, field), field
