"""The port's async micro-batching pipeline against the reference's, on the
CPU.

The eight ``test_async_*`` and ``test_result_cache_*`` cases of
``tests/test_pipeline.py`` run on the port's :class:`AsyncTopKServer`
(``device="cpu"``: no streams, no events, otherwise the same path) beside
the reference's over the same rows and queries. Every answer is held
against the reference's: values (1e-5 relative) and ids where scores are
distinct always, and ``n_scored``/``depth`` too where both servers ran the
query alone (one request in flight: the batch is the same on both sides,
so the counts are). Coalescing histograms depend on timing and are never
compared across packages. Last, ``examples/async_serving_torch.py`` runs
at its own small size. The reference's servers are not warmed: its
warmup compiles every bucket, which would dominate the file's time, and
only the port's warmup is under test. Every wait has a timeout.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import SepLRModel as RefModel
from repro.core import faults as ref_faults
from repro.serving.pipeline import AsyncTopKServer as RefAsync
from repro.serving.pipeline import ResultCache as RefCache
from repro.serving.server import AdmissionPolicy as RefPolicy
from repro_torch.core import SepLRModel, faults
from repro_torch.serving.pipeline import (AsyncTopKServer, PendingResult,
                                          PipelineStats, ResultCache)
from repro_torch.serving.server import AdmissionPolicy

from _torch_parity import assert_ids_where_distinct, assert_values

WAIT_S = 60
ROOT = Path(__file__).resolve().parents[1]


def _model(m=512, r=16, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((m, r)).astype(np.float32)
    U = rng.standard_normal((32, r)).astype(np.float32)
    return T, U


def _oracle_vals(T, U, k):
    s = U.astype(np.float64) @ T.astype(np.float64).T
    return np.sort(s, axis=1)[:, ::-1][:, :k]


def _servers(T, policy=None, **kw):
    """(reference, port) async servers over the same rows."""
    ref = RefAsync(RefModel(T), policy=None if policy is None
                   else RefPolicy(**policy), **kw)
    port = AsyncTopKServer(SepLRModel(T, device="cpu"), device="cpu",
                           policy=None if policy is None
                           else AdmissionPolicy(**policy), **kw)
    return ref, port


def _same(got, want, counts=True):
    assert_values(got.values, want.values)
    assert_ids_where_distinct(got.indices, want.indices, want.values)
    if counts:
        np.testing.assert_array_equal(got.n_scored,
                                      np.asarray(want.n_scored))
        np.testing.assert_array_equal(got.depth, np.asarray(want.depth))


def _ask(ref, port, u, k):
    """One request alone on each server: the port's, held against the
    reference's with its counts."""
    want = ref.submit(u, k).result(timeout=WAIT_S)
    got = port.submit(u, k).result(timeout=WAIT_S)
    _same(got, want)
    return got


def test_async_exact_and_coalesces():
    T, U = _model(m=1024)
    ref, srv = _servers(T, max_batch=8, flush_ms=5.0, method="bta")
    srv.warmup(5)
    with ref, srv:
        want = ref.query(U, 5)
        res = srv.query(U, 5, timeout=WAIT_S)  # 32 one-row submissions
        _same(res, want, counts=False)
        assert np.allclose(res.values, _oracle_vals(T, U, 5), atol=1e-4)
        ps = srv.pipeline_stats
        assert isinstance(ps, PipelineStats)
        assert ps.n_requests == 32
        # the device-busy window coalesces: fewer batches than requests
        assert ps.n_batches < ps.n_requests
        assert max(int(b) for b in ps.batch_size_hist) > 1
        st = srv.stats["bta"]
        assert len(st.req_lat_us_ring) == 32
        assert len(st.lat_us_ring) == ps.n_batches
    srv.close()                               # idempotent
    with pytest.raises(RuntimeError):
        srv.submit(U[0], 5)


def test_async_submit_validation():
    T, _ = _model()
    ref, srv = _servers(T, max_batch=4)
    with ref, srv:
        for s in (ref, srv):
            with pytest.raises(ValueError):
                s.submit(np.ones(16, np.float32), 0)
            with pytest.raises(ValueError):
                s.submit(np.ones(7, np.float32), 5)      # wrong rank
            with pytest.raises(ValueError):
                s.submit(np.full(16, np.nan, np.float32), 5)
            with pytest.raises(ValueError):
                s.submit(np.ones(16, np.float32), 5, deadline_ms=-1.0)


def test_async_deadline_shed_at_dispatch():
    T, U = _model()
    ref, srv = _servers(T, max_batch=4, method="bta",
                        policy={"deadline_ms": 0.0})
    srv.warmup(5)
    with ref, srv:
        res = srv.submit(U[0], 5).result(timeout=WAIT_S)
        _same(res, ref.submit(U[0], 5).result(timeout=WAIT_S))
        assert np.all(res.indices == -1)
        assert np.all(np.isneginf(res.values))
        assert np.all(np.isposinf(res.upper))
        assert srv.stats["bta"].degradations.get("shed", 0) >= 1
        assert srv.pipeline_stats.n_shed >= 1


def test_result_cache_lru_and_counters():
    for c in (ResultCache(capacity=2), RefCache(capacity=2)):
        c.insert(("a", 5, (0, 0)), ("ra",))
        c.insert(("b", 5, (0, 0)), ("rb",))
        assert c.lookup(("a", 5, (0, 0))) == ("ra",)  # refreshes "a"
        c.insert(("c", 5, (0, 0)), ("rc",))           # evicts "b"
        assert c.lookup(("b", 5, (0, 0))) is None
        assert c.lookup(("a", 5, (0, 0))) == ("ra",)
        assert c.hits == 2 and c.misses == 1 and len(c) == 2
        c.invalidate()
        assert len(c) == 0 and c.n_invalidations == 1


def test_async_cache_hits_and_mutation_invalidation():
    T, U = _model(m=1024)
    ref, srv = _servers(T, max_batch=8, method="bta", delta_capacity=16)
    srv.warmup(5)
    with ref, srv:
        u = U[0]
        r1 = _ask(ref, srv, u, 5)
        misses0 = srv.cache.misses
        handle = srv.submit(u, 5)
        assert isinstance(handle, PendingResult)
        r2 = handle.result(timeout=WAIT_S)
        assert handle.done()
        assert srv.cache.hits >= 1
        assert srv.cache.misses == misses0    # second ask never scanned
        assert np.array_equal(r1.values, r2.values)
        # ADD: a row that must be the new top-1
        big = 100.0 * u / max(float(np.linalg.norm(u)), 1e-9)
        gid = int(srv.add_targets(big[None])[0])
        assert int(ref.add_targets(big[None])[0]) == gid
        r3 = _ask(ref, srv, u, 5)
        assert int(r3.indices[0, 0]) == gid
        # DELETE: and it disappears again, exactly
        ref.delete_targets([gid])
        srv.delete_targets([gid])
        r4 = _ask(ref, srv, u, 5)
        assert gid not in set(r4.indices[0].tolist())
        assert np.allclose(r4.values[0], _oracle_vals(T, u[None], 5)[0],
                           atol=1e-4)
        # UPDATE through the delegating wrapper keeps exactness too
        gid2 = int(srv.add_targets(big[None])[0])
        ref.add_targets(big[None])
        ref.update_targets([gid2], -big[None])
        srv.update_targets([gid2], -big[None])
        r5 = _ask(ref, srv, u, 5)
        assert int(r5.indices[0, 0]) != gid2


def test_async_cache_never_serves_across_version_bump():
    T, U = _model(m=1024)
    ref, srv = _servers(T, max_batch=8, method="bta", delta_capacity=16)
    srv.warmup(5)
    with ref, srv:
        u = U[1]
        _ask(ref, srv, u, 5)
        assert len(srv.cache) == 1
        v0 = srv.catalogue.version
        rows = np.random.default_rng(9).standard_normal(
            (1, T.shape[1])).astype(np.float32)
        for s in (ref, srv):
            s.add_targets(rows)
            s.catalogue.compact(wait=True)    # version bump
        assert srv.catalogue.version > v0
        assert srv.catalogue.version == ref.catalogue.version
        # the compaction-fired listener emptied the cache, and the next
        # ask re-scans (a miss, not a hit) under the NEW token
        assert len(srv.cache) == 0
        hits0 = srv.cache.hits
        res = _ask(ref, srv, u, 5)
        assert srv.cache.hits == hits0
        live = np.concatenate([T, rows])
        assert np.allclose(res.values[0], _oracle_vals(live, u[None], 5)[0],
                           atol=1e-4)


def test_async_cache_safe_under_failed_build():
    """A fault-injected FAILED compaction build must not let the cache
    serve pre-mutation answers, on either package."""
    T, U = _model(m=1024)
    ref, srv = _servers(T, max_batch=8, method="bta", delta_capacity=4)
    srv.warmup(5)
    rank = T.shape[1]
    with ref, srv:
        u = U[2]
        _ask(ref, srv, u, 5)                  # prime the caches
        big = 50.0 * u / max(float(np.linalg.norm(u)), 1e-9)
        with ref_faults.injected("compaction.build",
                                 error=ref_faults.FaultInjected), \
                faults.injected("compaction.build",
                                error=faults.FaultInjected):
            gids = [int(srv.add_targets(big[None])[0])]
            ref.add_targets(big[None])
            for _ in range(6):
                small = 0.01 * np.ones((1, rank), np.float32)
                gids.append(int(srv.add_targets(small)[0]))
                ref.add_targets(small)
            assert srv.catalogue.stats.n_failed_compactions >= 1
            assert (srv.catalogue.stats.n_failed_compactions
                    == ref.catalogue.stats.n_failed_compactions)
            res = _ask(ref, srv, u, 5)
            assert int(res.indices[0, 0]) == gids[0]
        for s in (ref, srv):
            s.catalogue.compact(wait=True)    # recovery folds the chain
        res2 = _ask(ref, srv, u, 5)
        assert int(res2.indices[0, 0]) == gids[0]


def test_async_compaction_compile_free():
    """Queue-formed micro-batches through ``auto`` across compactions load
    no kernel library (the port's compile), and the final state is exact
    on both packages."""
    rng = np.random.default_rng(11)
    T = rng.standard_normal((613, 22)).astype(np.float32)
    U = rng.standard_normal((64, 22)).astype(np.float32)
    ref, srv = _servers(T, max_batch=8, method="auto", delta_capacity=8)
    srv.warmup(6)
    with ref, srv:
        _same(srv.query(U[:16], 6, timeout=WAIT_S), ref.query(U[:16], 6),
              counts=False)
        for i in range(20):                   # forces >= 2 compactions
            row = rng.standard_normal((1, 22)).astype(np.float32)
            ref.add_targets(row)
            srv.add_targets(row)
            if i % 5 == 0:
                _same(srv.query(U[16 + i:17 + i], 6, timeout=WAIT_S),
                      ref.query(U[16 + i:17 + i], 6), counts=False)
        srv.catalogue.flush()
        ref.catalogue.flush()
        _same(srv.query(U[:32], 6, timeout=WAIT_S), ref.query(U[:32], 6),
              counts=False)
        ms, want = srv.mutation_stats, ref.mutation_stats
        assert ms["n_compactions"] >= 1
        assert ms["n_compactions"] == want["n_compactions"]
        assert ms["engine_compiles_per_compaction"] == 0, ms
    live, _ = srv.catalogue.as_dense()
    res = srv.server.query(U[:4], 6, "norm")
    assert np.allclose(res.values, _oracle_vals(live, U[:4], 6), atol=1e-4)
    _same(res, ref.server.query(jnp.asarray(U[:4]), 6, "norm"))


@pytest.mark.parametrize("method", ["topk_mips", "bta"])
def test_async_over_the_ladder_matches_reference(method):
    """``AsyncTopKServer(n_shards=4)``: single requests through folds, an
    L1 kill and a promotion equal the reference's, counts included."""
    T, U = _model(m=300, r=12, seed=4)
    ref, srv = _servers(T, max_batch=8, method=method, delta_capacity=8,
                        n_shards=4)
    ref_method = "pallas" if method == "topk_mips" else method
    ref.method = ref_method
    rng = np.random.default_rng(5)
    with ref, srv:
        rows = rng.standard_normal((30, 12)).astype(np.float32)
        gids = ref.add_targets(rows)
        np.testing.assert_array_equal(srv.add_targets(rows), gids)
        assert srv.catalogue.l1_rows > 0
        assert srv.catalogue.stats.n_l1_folds == \
            ref.catalogue.stats.n_l1_folds
        for u in U[:3]:
            _ask(ref, srv, u, 5)
        for s in (ref, srv):
            s.delete_targets([int(gids[0]), 3])
        for u in U[3:6]:
            _ask(ref, srv, u, 5)
        for s in (ref, srv):
            s.catalogue.promote(wait=True)
        assert srv.catalogue.l1_rows == 0
        for u in U[6:9]:
            _ask(ref, srv, u, 5)


def test_async_serving_example_runs_on_cpu():
    """``examples/async_serving_torch.py`` at its own small size on the
    CPU, over a 4-shard ladder (its mutation folds): every request of the
    burst and the post-mutation query exact. One intra-op thread: the
    example's threads and the test workers would oversubscribe the CPU."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "async_serving_torch.py"),
         "--device", "cpu", "--targets", "2000", "--shards", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert ", 0 wrong" in out.stdout
    assert "done — all results exact" in out.stdout
    assert "4 L1 shards" in out.stdout and "1 folds" in out.stdout


# the stage thread that dies re-raises after recording its error: pytest
# reports that as an unhandled thread exception, which is the point here
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_async_errors_fail_their_batch_and_close_reraises(monkeypatch):
    """A dispatch error and a harvest error each fail their batch's
    futures (never a hang), leave no batch counted in flight, and the next
    request is served; an error that ends a stage thread fails the queued
    requests and ``close()`` re-raises it."""
    T, U = _model()
    srv = AsyncTopKServer(SepLRModel(T, device="cpu"), max_batch=4,
                          method="norm", device="cpu")
    cat = srv.catalogue
    with srv:
        real_query = cat.query
        monkeypatch.setattr(cat, "query", lambda *a, **k: (_ for _ in ())
                            .throw(RuntimeError("dispatch boom")))
        with pytest.raises(RuntimeError, match="dispatch boom"):
            srv.submit(U[0], 5).result(timeout=WAIT_S)
        monkeypatch.setattr(cat, "query", real_query)
        real_harvest = srv._harvest_batch
        monkeypatch.setattr(srv, "_harvest_batch", lambda *a: (_ for _ in ())
                            .throw(ValueError("harvest boom")))
        with pytest.raises(ValueError, match="harvest boom"):
            srv.submit(U[1], 5).result(timeout=WAIT_S)
        monkeypatch.setattr(srv, "_harvest_batch", real_harvest)
        assert srv._inflight_batches == 0
        res = srv.submit(U[2], 5).result(timeout=WAIT_S)
        assert np.allclose(res.values, _oracle_vals(T, U[2:3], 5), atol=1e-4)
    srv = AsyncTopKServer(SepLRModel(T, device="cpu"), max_batch=4,
                          method="norm", device="cpu")
    monkeypatch.setattr(srv, "_form_batch_locked", lambda: (_ for _ in ())
                        .throw(KeyError("loop boom")))
    srv.start()
    with pytest.raises(KeyError, match="loop boom"):
        srv.submit(U[0], 5).result(timeout=WAIT_S)
    with pytest.raises(KeyError, match="loop boom"):
        srv.close()
    assert not srv._harvester or not srv._harvester.is_alive()
