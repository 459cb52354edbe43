"""The port's fault registry and compaction recovery against the
reference's, case for case with ``tests/test_faults.py`` (its LSM-ladder
cases wait for that slice).

The registry cases run on both packages' ``faults`` modules, and the
registered points must be the reference's. Deterministic recovery
schedules (synchronous builds, or asynchronous ones joined with
``flush``) run through both packages in lockstep
(:class:`_torch_streaming_pair.Pair`, each package's point armed alike),
so every query and every counter equals the reference's; the schedules
that race a build thread against the clock (the chain cap, the
watchdog, the retry timer) run the reference's assertions on each
package's catalogue."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import SegmentedCatalogue as RefCatalogue
from repro.core import faults as ref_faults
from repro.core import get_engine as ref_get_engine
from repro_torch.core import SegmentedCatalogue, faults, get_engine

from _torch_streaming_pair import (Pair, arm_both, disarm_all_both,
                                   injected_both)

R = 10
K = 5
PACKAGES = ("reference", "port")
FAULTS = {"reference": ref_faults, "port": faults}


@pytest.fixture(autouse=True)
def _clean_faults():
    disarm_all_both()
    yield
    disarm_all_both()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _base(rng, m=200):
    return rng.standard_normal((m, R)).astype(np.float32)


def _make(pkg, targets, **kw):
    if pkg == "reference":
        return RefCatalogue(targets, **kw)
    return SegmentedCatalogue(targets, device="cpu", **kw)


def _oracle(cat, U, k):
    rows, gids = cat.as_dense()
    U = np.atleast_2d(np.asarray(U, np.float32))
    s = U.astype(np.float64) @ rows.astype(np.float64).T
    order = np.argsort(-s, kind="stable", axis=1)[:, :k]
    return s[np.arange(U.shape[0])[:, None], order], gids[order]


def assert_exact(cat, U, k=K, engine="norm"):
    """The catalogue (a Pair, or one package's) against the oracle."""
    if isinstance(cat, Pair):
        res, info = cat.query(engine, U, k)
    elif isinstance(cat, RefCatalogue):
        res, info = cat.query(ref_get_engine(engine), jnp.asarray(U), k)
    else:
        res, info = cat.query(get_engine(engine), U, k)
    ov, _ = _oracle(cat, U, k)
    kk = min(k, cat.num_live)
    np.testing.assert_allclose(np.asarray(res.values)[:, :kk], ov[:, :kk],
                               atol=1e-4)
    return res, info


# -- the registry itself -----------------------------------------------------

def test_points_are_the_reference_points():
    assert faults.list_points() == ref_faults.list_points()
    assert faults.__all__ == ref_faults.__all__


@pytest.mark.parametrize("pkg", PACKAGES)
def test_registry_basics(pkg):
    fm = FAULTS[pkg]
    assert "compaction.build" in fm.list_points()
    with pytest.raises(ValueError, match="unknown fault point"):
        fm.arm("no.such.point")
    with pytest.raises(ValueError, match="p must be"):
        fm.arm("compaction.build", p=0.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_times_auto_disarms_and_counters_survive(pkg):
    fm = FAULTS[pkg]
    before = fm.counters()["delta.overflow"]["fired"]
    fm.arm("delta.overflow", times=2)
    assert fm.fire("delta.overflow")
    assert fm.fire("delta.overflow")
    assert not fm.fire("delta.overflow")
    assert fm.counters()["delta.overflow"]["fired"] == before + 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_after_skips_initial_fires(pkg):
    fm = FAULTS[pkg]
    fm.arm("delta.overflow", times=1, after=2)
    assert not fm.fire("delta.overflow")
    assert not fm.fire("delta.overflow")
    assert fm.fire("delta.overflow")


def test_seeded_coin_is_deterministic_and_the_references():
    def run(fm, seed):
        fm.arm("delta.overflow", times=None, p=0.5, seed=seed)
        out = [fm.fire("delta.overflow") for _ in range(32)]
        fm.disarm("delta.overflow")
        return out

    assert run(faults, 7) == run(faults, 7)
    assert run(faults, 7) != run(faults, 8)
    # the same coin: a schedule replays alike in both packages
    assert run(faults, 7) == run(ref_faults, 7)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_injected_context_raises_and_disarms(pkg):
    fm = FAULTS[pkg]
    with fm.injected("compaction.build", error=fm.FaultInjected):
        with pytest.raises(fm.FaultInjected, match="compaction.build"):
            fm.fire("compaction.build")
    assert not fm.fire("compaction.build")


# -- mutation input validation ----------------------------------------------

def test_mutations_reject_nonfinite_and_wrong_rank():
    rng = _rng(1)
    cat = Pair(_base(rng), block_size=16)
    bad = np.ones((2, R), np.float32)
    bad[1, 3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        cat.add_targets(bad)
    with pytest.raises(ValueError, match="rank mismatch"):
        cat.add_targets(np.ones((2, R + 1), np.float32))
    inf_row = np.full((1, R), np.inf, np.float32)
    with pytest.raises(ValueError, match="non-finite"):
        cat.update_targets([0], inf_row)
    with pytest.raises(ValueError, match="rank mismatch"):
        cat.update_targets([0], np.ones((1, R - 2), np.float32))
    assert cat.num_live == 200 and cat.delta_occupancy == 0
    cat.check_state()


# -- repeated build failure: exactness + recovery ----------------------------

def test_n_consecutive_build_failures_serve_exact_then_refold():
    rng = _rng(2)
    cat = Pair(_base(rng), delta_capacity=8, block_size=16,
               compact_async=True, max_l0_segments=16,
               build_backoff_s=0.01)
    U = rng.standard_normal((3, R)).astype(np.float32)
    n_faults = 4
    arm_both("compaction.build", error=RuntimeError, times=n_faults)
    for i in range(n_faults):
        cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
        cat.flush()
        assert_exact(cat, U)
        cat.check_state()
        if cat.consecutive_build_failures >= 2:
            time.sleep(cat.current_backoff_s + 0.01)
    assert cat.stats.n_failed_compactions == n_faults
    assert cat.consecutive_build_failures == n_faults
    assert isinstance(cat.last_build_error, RuntimeError)
    chain_before = cat.l0_chain_len
    assert chain_before >= 2
    assert cat.stats.max_l0_chain >= chain_before
    cat.compact(wait=True)
    assert cat.l0_chain_len == 0
    assert cat.last_build_error is None
    assert cat.consecutive_build_failures == 0
    assert cat.current_backoff_s == 0.0
    assert cat.stats.n_compactions == 1
    assert cat.stats.n_build_retries >= 1
    assert_exact(cat, U)
    cat.check_state()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_chain_cap_forces_synchronous_compaction(pkg):
    rng = _rng(3)
    cat = _make(pkg, _base(rng), delta_capacity=4, block_size=16,
                compact_async=True, max_l0_segments=2, build_backoff_s=5.0)
    U = rng.standard_normal((2, R)).astype(np.float32)
    FAULTS[pkg].arm("compaction.build", error=RuntimeError, times=2)
    for _ in range(2):
        cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
        cat.flush()
    assert cat.stats.n_failed_compactions == 2
    for _ in range(4):
        cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
    assert cat.l0_chain_len <= 2
    assert cat.stats.n_forced_sync_compactions >= 1
    assert cat.stats.n_compactions >= 1
    assert cat.consecutive_build_failures == 0
    assert_exact(cat, U)
    cat.flush()


def test_backoff_gates_ordinary_retries():
    rng = _rng(4)
    cat = Pair(_base(rng), delta_capacity=64, block_size=16,
               compact_async=False, max_l0_segments=32,
               build_backoff_s=0.25, build_backoff_max_s=1.0)
    row = rng.standard_normal((1, R)).astype(np.float32)
    cat.add_targets(row)
    arm_both("compaction.build", error=RuntimeError, times=2)
    with injected_both("delta.overflow", times=3):
        cat.add_targets(row)
        assert cat.consecutive_build_failures == 1
        cat.add_targets(row)
        assert cat.consecutive_build_failures == 2
        assert cat.current_backoff_s == pytest.approx(0.5)
        cat.add_targets(row)
        assert cat.stats.n_failed_compactions == 2
    time.sleep(cat.current_backoff_s + 0.05)
    with injected_both("delta.overflow", times=1):
        cat.add_targets(row)
    assert cat.consecutive_build_failures == 0
    assert cat.l0_chain_len == 0
    assert cat.stats.n_build_retries >= 1
    cat.check_state()


def test_retry_limit_stops_ordinary_attempts_but_not_forced():
    rng = _rng(5)
    cat = Pair(_base(rng), delta_capacity=64, block_size=16,
               compact_async=False, max_l0_segments=32,
               build_retry_limit=1, build_backoff_s=0.0)
    row = rng.standard_normal((1, R)).astype(np.float32)
    cat.add_targets(row)
    arm_both("compaction.build", error=RuntimeError, times=10)
    with injected_both("delta.overflow", times=4):
        cat.add_targets(row)
        cat.add_targets(row)
        fails = cat.stats.n_failed_compactions
        assert fails == 2
        cat.add_targets(row)
        cat.add_targets(row)
        assert cat.stats.n_failed_compactions == fails
    with pytest.raises(RuntimeError, match="compaction build failed"):
        cat.compact(wait=True)
    assert cat.stats.n_failed_compactions == fails + 1
    disarm_all_both()
    cat.compact(wait=True)
    assert cat.consecutive_build_failures == 0
    cat.check_state()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_watchdog_flags_stuck_build_once(pkg):
    rng = _rng(6)
    cat = _make(pkg, _base(rng), delta_capacity=8, block_size=16,
                compact_async=True, build_watchdog_s=0.05)
    FAULTS[pkg].arm("compaction.stall", delay_s=0.4)
    cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
    deadline = time.monotonic() + 2.0
    flagged = False
    while time.monotonic() < deadline and not flagged:
        flagged = cat.check_watchdog()
        time.sleep(0.02)
    assert flagged
    assert cat.stats.n_stuck_builds == 1
    cat.check_watchdog()
    assert cat.stats.n_stuck_builds == 1
    cat.flush()
    assert cat.stats.n_compactions == 1
    assert cat.l0_chain_len == 0


def test_warm_phase_failure_is_a_recorded_build_failure():
    rng = _rng(7)
    cat = Pair(_base(rng), delta_capacity=8, block_size=16,
               compact_async=False)
    U = rng.standard_normal((2, R)).astype(np.float32)
    with injected_both("compaction.warm", error=RuntimeError):
        cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
    assert cat.stats.n_failed_compactions == 1
    assert cat.l0_chain_len >= 1
    assert_exact(cat, U)
    cat.compact(wait=True)
    assert cat.last_build_error is None
    assert_exact(cat, U)
    cat.check_state()


def test_injected_delta_overflow_seals_early():
    rng = _rng(8)
    cat = Pair(_base(rng), delta_capacity=64, block_size=16,
               compact_async=False)
    U = rng.standard_normal((2, R)).astype(np.float32)
    cat.add_targets(rng.standard_normal((2, R)).astype(np.float32))
    with injected_both("delta.overflow", times=1):
        cat.add_targets(rng.standard_normal((4, R)).astype(np.float32))
    assert cat.stats.n_compactions == 1
    assert cat.num_live == 206
    assert_exact(cat, U)
    cat.check_state()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_auto_retry_timer_heals_a_quiet_catalogue(pkg):
    rng = _rng(9)
    cat = _make(pkg, _base(rng), delta_capacity=8, block_size=16,
                compact_async=True, auto_retry=True, build_backoff_s=0.05)
    with FAULTS[pkg].injected("compaction.build", error=RuntimeError,
                              times=1):
        cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
        cat.flush()
    assert cat.stats.n_failed_compactions == 1
    assert cat.retry_pending
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline and cat.l0_chain_len:
        time.sleep(0.02)
    cat.flush()
    assert cat.l0_chain_len == 0
    assert cat.consecutive_build_failures == 0
    assert cat.stats.n_compactions == 1


def test_stale_pending_dead_does_not_kill_updated_row():
    rng = _rng(35)
    cat = Pair(_base(rng, 32), delta_capacity=4, compact_async=False,
               build_backoff_s=0.0, block_size=16)
    gids = cat.add_targets(rng.standard_normal((4, R)).astype(np.float32))
    arm_both("compaction.build", error=RuntimeError, times=1)
    with pytest.raises(RuntimeError):
        cat.compact(wait=True)
    assert cat.l0_chain_len >= 1
    victim = int(gids[0])
    new_row = np.full((1, R), 3.0, np.float32)
    cat.update_targets([victim], new_row)
    n_live = cat.num_live
    cat.compact(wait=True)
    assert cat.num_live == n_live
    res, _ = cat.query("norm", np.ones((1, R), np.float32), 1)
    assert int(res.indices[0, 0]) == victim
    np.testing.assert_allclose(float(res.values[0, 0]), 3.0 * R, rtol=1e-5)
    assert_exact(cat, rng.standard_normal((2, R)).astype(np.float32))
    cat.check_state()
