"""The port's observability layer against the reference's.

``tests/test_obs.py``'s cases up to ``test_fault_firing_emits_event``
run on both packages (``pkg``): the registry, histograms, snapshot
schema, Prometheus text, tracer, journal, the ``ServeStats`` façade,
``mutation_stats``' schema, concurrent recording, the live certificate
metrics and the fault event; its two async-pipeline cases (one
request's span tree joins the compaction and the L0 -> L1 fold events
of the journal by ``(version, epoch)``) run on the port. Then the same
served sequence — chunked queries, a budgeted and a shed chunk,
mutations through a compaction — through both servers gives the same
snapshot keys and series, valid under both schemas, and the same
Prometheus sample names."""

import threading
import types

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro_torch.obs as obs
from repro.core import SepLRModel as RefModel
from repro.core import certificate_gaps as ref_certificate_gaps
from repro.core import ShardedLsmCatalogue as RefLsm
from repro.core import faults as ref_faults
from repro.core.engines import batch_bucket as ref_batch_bucket
from repro.serving.server import LATENCY_RING as REF_LATENCY_RING
from repro.serving.server import ServeStats as RefServeStats
from repro.serving.pipeline import AsyncTopKServer as RefAsync
from repro.serving.server import TopKServer as RefServer
from repro_torch.core import (SepLRModel, ShardedLsmCatalogue,
                              certificate_gaps, faults)
from repro_torch.serving.pipeline import AsyncTopKServer
from repro_torch.core.engines import batch_bucket
from repro_torch.serving.server import LATENCY_RING, ServeStats, TopKServer

PKGS = {
    "reference": types.SimpleNamespace(
        obs=ref_obs, ServeStats=RefServeStats, LATENCY_RING=REF_LATENCY_RING,
        faults=ref_faults, certificate_gaps=ref_certificate_gaps,
        batch_bucket=ref_batch_bucket,
        server=lambda T, **kw: RefServer(RefModel(T), **kw),
        async_server=lambda T, **kw: RefAsync(RefModel(T), **kw),
        ShardedLsmCatalogue=RefLsm),
    "port": types.SimpleNamespace(
        obs=obs, ServeStats=ServeStats, LATENCY_RING=LATENCY_RING,
        faults=faults, batch_bucket=batch_bucket,
        # the server answers on the host; the port's function takes tensors
        certificate_gaps=lambda res: certificate_gaps(type(res)(*(
            None if x is None else torch.as_tensor(x) for x in res))),
        server=lambda T, **kw: TopKServer(SepLRModel(T, device="cpu"),
                                          device="cpu", **kw),
        async_server=lambda T, **kw: AsyncTopKServer(
            SepLRModel(T, device="cpu"), device="cpu", **kw),
        ShardedLsmCatalogue=ShardedLsmCatalogue),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """One package's namespace, its default stores empty and enabled."""
    p = PKGS[request.param]
    p.obs.reset()
    p.obs.set_enabled(True)
    p.obs.TRACER.sample_rate = 1.0
    yield p
    p.obs.reset()
    p.obs.set_enabled(True)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counter_labels_and_total(pkg):
    reg = pkg.obs.MetricsRegistry()
    c = reg.counter("t_requests_total", "x", labels=("engine",))
    c.inc(engine="bta")
    c.inc(2, engine="norm")
    assert c.value(engine="bta") == 1
    assert c.value(engine="norm") == 2
    assert c.value(engine="nope") == 0
    assert c.total() == 3


def test_registry_get_or_create_rejects_mismatch(pkg):
    reg = pkg.obs.MetricsRegistry()
    reg.counter("t_thing", "x", labels=("a",))
    assert reg.counter("t_thing", "x", labels=("a",)) is reg.get("t_thing")
    with pytest.raises(ValueError):
        reg.counter("t_thing", "x", labels=("b",))
    with pytest.raises(ValueError):
        reg.gauge("t_thing", "x", labels=("a",))
    with pytest.raises(ValueError):
        reg.counter("bad name!", "x")


def test_histogram_ring_percentile_matches_numpy(pkg):
    reg = pkg.obs.MetricsRegistry()
    h = reg.histogram("t_lat_us", "x", buckets=pkg.obs.LATENCY_BUCKETS_US,
                      ring=64)
    rng = np.random.default_rng(3)
    vals = rng.lognormal(5, 2, size=200)
    for v in vals:
        h.observe(float(v))
    window = np.asarray(list(h.ring()))
    assert len(window) == 64
    for q in (50, 95, 99):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(window, q)))
    assert h.count() == 200
    assert h.mean() == pytest.approx(float(vals.mean()))


def test_histogram_bucketless_series_and_empty(pkg):
    reg = pkg.obs.MetricsRegistry()
    h = reg.histogram("t_noring", "x", buckets=(1.0, 10.0, 100.0))
    assert h.percentile(50) == 0.0
    h.observe(5.0)
    assert h.percentile(50) == 10.0
    with pytest.raises(ValueError):
        h.ring()


def test_snapshot_validates_and_prom_parses(pkg):
    o = pkg.obs
    o.on_batch_served("bta", 4, 100, 40, 1000, 250.0, "nonneg")
    o.on_degradation("bta", "shed")
    o.on_compaction("success", duration_s=0.01, version=1, epoch=2)
    snap = o.REGISTRY.snapshot()
    o.validate_snapshot(snap)
    samples = o.parse_prom_text(o.REGISTRY.render_prom())
    assert samples['repro_queries_total{engine="bta"}'] == 4
    assert samples["repro_shed_total"] == 1
    assert samples["repro_compaction_seconds_count"] == 1
    assert any(k.startswith("repro_batch_latency_us_bucket")
               for k in samples)


def test_snapshot_schema_rejects_garbage(pkg):
    with pytest.raises(ValueError):
        pkg.obs.validate_snapshot({"nope": 1})
    with pytest.raises(ValueError):
        pkg.obs.validate_snapshot(
            {"metrics": {"m": {"kind": "sundial", "help": "",
                               "labels": [], "series": []}}})


def test_disable_switch_stops_recording(pkg):
    o = pkg.obs
    o.set_enabled(False)
    o.on_batch_served("bta", 4, 100, 40, 1000, 250.0)
    o.on_fault_fired("compaction.build")
    assert o.QUERIES.total() == 0
    assert len(o.JOURNAL) == 0
    assert o.TRACER.start_trace("x") is None
    o.set_enabled(True)
    o.on_batch_served("bta", 4, 100, 40, 1000, 250.0)
    assert o.QUERIES.total() == 4


# ---------------------------------------------------------------------------
# trace spans + event journal
# ---------------------------------------------------------------------------

def test_tracer_every_nth_sampling_is_deterministic(pkg):
    tr = pkg.obs.Tracer(capacity=16, sample_rate=0.25)
    kept = [tr.start_trace("t") is not None for _ in range(100)]
    assert sum(kept) == 25
    tr2 = pkg.obs.Tracer(capacity=16, sample_rate=0.25)
    assert kept == [tr2.start_trace("t") is not None for _ in range(100)]


def test_trace_tree_and_store_bound(pkg):
    tr = pkg.obs.Tracer(capacity=2)
    for i in range(3):
        t = tr.start_trace("req", k=i)
        t.span("queue_wait", start=0.0, end=0.5)
        t.span("device", start=0.5, end=1.0, engine="bta")
        t.finish()
    done = tr.traces()
    assert len(done) == 2
    tree = done[-1].format_tree()
    assert "queue_wait" in tree and "engine=bta" in tree
    assert done[-1].find("device").duration_us == pytest.approx(5e5)


def test_journal_filter_tail_and_capacity(pkg):
    j = pkg.obs.EventJournal(capacity=8)
    for i in range(12):
        j.emit("tick", i=i, kind_field="x")
    assert len(j) == 8
    assert [e.fields["i"] for e in j.tail(3)] == [9, 10, 11]
    assert len(j.events("tick", i=10)) == 1
    assert j.counts() == {"tick": 12}
    d = j.tail(1)[0].as_dict()
    assert d["kind"] == "tick" and d["seq"] == 12


# ---------------------------------------------------------------------------
# ServeStats façade + mutation_stats schema
# ---------------------------------------------------------------------------

def test_servestats_facade_unchanged(pkg):
    s = pkg.ServeStats()
    for i in range(pkg.LATENCY_RING + 57):
        s.lat_us_ring.append(float(i))
    assert len(s.lat_us_ring) == pkg.LATENCY_RING
    want = np.asarray(s.lat_us_ring)
    assert s.p50_us == pytest.approx(float(np.percentile(want, 50)))
    assert s.p99_us == pytest.approx(float(np.percentile(want, 99)))
    s.record_request_latency(100.0)
    s.record_request_latency(300.0)
    assert s.req_p50_us == pytest.approx(200.0)
    assert len(s.req_lat_us_ring) == 2
    s.record_batch(4, 100, 40, 0.001, 8, "nonneg")
    assert (s.n_queries, s.n_scored, s.depth_sum, s.delta_scored) == \
        (4, 100, 40, 8)
    assert s.sign_batches == {"nonneg": 1}
    assert s.scores_per_query == 25.0
    s.bump_degradation("shed")
    s.note_uncertified(2)
    assert s.degradations == {"shed": 1} and s.n_uncertified == 2


def test_servestats_records_when_obs_disabled(pkg):
    pkg.obs.set_enabled(False)
    s = pkg.ServeStats()
    s.record_batch(1, 10, 5, 0.001)
    s.record_request_latency(42.0)
    assert s.n_queries == 1 and len(s.lat_us_ring) == 1
    assert s.req_p50_us == pytest.approx(42.0)


def test_mutation_stats_matches_declared_schema(pkg):
    rng = np.random.default_rng(0)
    T = rng.standard_normal((193, 7)).astype(np.float32)
    srv = pkg.server(T, delta_capacity=8)
    ms = srv.mutation_stats
    assert set(ms) == set(pkg.obs.MUTATION_STATS_SCHEMA)
    for key, field in pkg.obs.MUTATION_STATS_SCHEMA.items():
        assert isinstance(ms[key], field.type), key
        assert field.doc
    with pytest.raises(KeyError):
        pkg.obs.build_mutation_stats({**ms, "surprise": 1})
    short = dict(ms)
    short.popitem()
    with pytest.raises(KeyError):
        pkg.obs.build_mutation_stats(short)


# ---------------------------------------------------------------------------
# thread-safety hammer
# ---------------------------------------------------------------------------

def test_concurrent_recording_loses_nothing(pkg):
    rng = np.random.default_rng(1)
    T = rng.standard_normal((211, 7)).astype(np.float32)
    srv = pkg.server(T, delta_capacity=8)
    s = pkg.ServeStats()
    c = pkg.obs.REGISTRY.counter("t_hammer_total", "x", labels=("t",))
    N_THREADS, N_ITER = 8, 400
    errors = []
    go = threading.Event()

    def writer(tid):
        go.wait()
        try:
            for i in range(N_ITER):
                s.record_batch(1, 10, 5, 1e-6, 0, "s%d" % (i % 3))
                s.record_request_latency(float(i))
                c.inc(t=str(tid))
        except BaseException as e:   # noqa: BLE001 — the assertion
            errors.append(e)

    def reader():
        go.wait()
        try:
            for _ in range(N_ITER):
                s.p99_us, s.req_p50_us, s.scores_per_query
                pkg.obs.REGISTRY.render_prom()
        except BaseException as e:   # noqa: BLE001 — the assertion
            errors.append(e)

    def mutator():
        go.wait()
        try:
            for i in range(24):
                srv.add_targets(rng.standard_normal((4, 7))
                                .astype(np.float32))
        except BaseException as e:   # noqa: BLE001 — the assertion
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(N_THREADS)]
    threads += [threading.Thread(target=reader),
                threading.Thread(target=mutator)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert s.n_queries == N_THREADS * N_ITER
    assert s.n_scored == 10 * N_THREADS * N_ITER
    assert sum(s.sign_batches.values()) == N_THREADS * N_ITER
    assert c.total() == N_THREADS * N_ITER
    for tid in range(N_THREADS):
        assert c.value(t=str(tid)) == N_ITER
    assert srv.mutation_stats["n_compactions"] >= 1
    assert pkg.obs.CACHE_INVALIDATIONS.total() == 0
    assert len(pkg.obs.JOURNAL.events("compaction.success")) >= 1


# ---------------------------------------------------------------------------
# live certificate metrics pinned against certificate_gaps
# ---------------------------------------------------------------------------

def test_certificate_metrics_match_ground_truth(pkg):
    rng = np.random.default_rng(5)
    T = rng.standard_normal((223, 7)).astype(np.float32)
    srv = pkg.server(T)
    U = rng.standard_normal((4, 7)).astype(np.float32)
    budget = 3
    res = srv.query(U, k=5, method="norm", budget=budget)
    gaps = np.asarray(pkg.certificate_gaps(res))
    valid = np.asarray(res.indices) >= 0
    unc = np.logical_and(gaps > 0, np.isfinite(gaps))
    want_frac = 1.0 - unc.sum() / max(valid.sum(), 1)
    bucket = str(pkg.batch_bucket(budget))
    o = pkg.obs
    assert o.CERTIFIED_FRACTION.count(engine="norm",
                                      budget_bucket=bucket) == 1
    assert o.CERTIFIED_FRACTION.sum(
        engine="norm", budget_bucket=bucket) == pytest.approx(want_frac)
    if unc.any():
        want_gap = float(gaps[unc].mean())
        assert o.UNCERTIFIED_GAP.sum(engine="norm", budget_bucket=bucket) \
            == pytest.approx(want_gap, rel=1e-5)
        n_unc_q = int(np.sum(np.any(unc, axis=1)))
        assert o.UNCERTIFIED.value(engine="norm") == n_unc_q
        assert srv.stats["norm"].n_uncertified == n_unc_q


# ---------------------------------------------------------------------------
# fault seams
# ---------------------------------------------------------------------------

def test_fault_firing_emits_event(pkg):
    with pkg.faults.injected("compaction.build", error=None, times=1):
        assert pkg.faults.fire("compaction.build")
    assert pkg.obs.FAULTS_FIRED.value(point="compaction.build") == 1
    ev = pkg.obs.JOURNAL.events("fault.fired")
    assert ev and ev[-1].fields["point"] == "compaction.build"


# the reference's arm of the two async cases is tests/test_obs.py's own
# (its warmup compiles every bucket: minutes of this file's time)
@pytest.mark.parametrize("pkg", ["port"], indirect=True)
def test_async_request_span_joins_compaction_event(pkg):
    """One async request's span tree names the engine, the cost-table
    entry, the stage spans and the (version, epoch) it ran against, and
    that version joins the compaction.success event that made the
    snapshot."""
    obs_ = pkg.obs
    rng = np.random.default_rng(9)
    T = rng.standard_normal((227, 7)).astype(np.float32)
    with pkg.async_server(T, max_batch=8, delta_capacity=8,
                          method="bta") as srv:
        srv.warmup(4)
        obs_.reset()
        # force a synchronous compaction: > capacity appends
        srv.add_targets(rng.standard_normal((9, 7)).astype(np.float32))
        comp = obs_.JOURNAL.events("compaction.success")
        assert comp, "mutation burst must have compacted"
        version = comp[-1].fields["version"]
        h = srv.submit(rng.standard_normal(7).astype(np.float32), 4)
        h.result(timeout=60)
        t = obs_.TRACER.traces()[-1]
        names = [sp.name for sp in t.spans]
        for stage in ("queue_wait", "coalesce", "route", "dispatch",
                      "device", "harvest", "merge"):
            assert stage in names, stage
        assert all(sp.t_end is not None for sp in t.spans)
        dev = t.find("device")
        assert dev.attrs["engine"] == "bta"
        assert "bta" in t.find("route").attrs["cost_entry"]
        assert t.find("queue_wait").duration_us >= 0.0
        assert dev.attrs["version"] == version
        assert t.root.attrs["version"] == version
        joined = obs_.JOURNAL.events("compaction.success",
                                     version=dev.attrs["version"])
        assert len(joined) == 1
        assert obs_.QUERIES.value(engine="bta") >= 1
        assert obs_.REQUEST_LATENCY.count(engine="bta") >= 1


@pytest.mark.parametrize("pkg", ["port"], indirect=True)
def test_async_request_span_joins_fold_event(pkg):
    """Across the LSM ladder (4 shards): an L0 -> L1 fold journals
    compaction.fold_l1 under the same (version, epoch) join keys, moves no
    epoch, and a traced request that ran against the folded catalogue
    joins it by both keys."""
    obs_ = pkg.obs
    rng = np.random.default_rng(23)
    T = rng.standard_normal((113, 7)).astype(np.float32)
    with pkg.async_server(T, max_batch=8, delta_capacity=8, method="bta",
                          n_shards=4) as srv:
        assert isinstance(srv.server.catalogue, pkg.ShardedLsmCatalogue)
        srv.warmup(4)
        obs_.reset()
        srv.add_targets(rng.standard_normal((5, 7)).astype(np.float32))
        token = srv.catalogue.cache_token()
        srv.server.catalogue.compact(wait=True)
        assert srv.catalogue.cache_token() == token   # a fold moves nothing
        folds = obs_.JOURNAL.events("compaction.fold_l1")
        assert folds, "overflow must have folded, not rebuilt"
        assert not obs_.JOURNAL.events("compaction.success")
        ev = folds[-1].fields
        assert ev["rows_folded"] >= 1 and ev["l1_rows"] >= 1
        h = srv.submit(rng.standard_normal(7).astype(np.float32), 4)
        h.result(timeout=60)
        dev = obs_.TRACER.traces()[-1].find("device")
        assert dev.attrs["version"] == ev["version"]
        assert dev.attrs["epoch"] == ev["epoch"]
        joined = obs_.JOURNAL.events("compaction.fold_l1",
                                     version=dev.attrs["version"],
                                     epoch=dev.attrs["epoch"])
        assert joined and joined[-1].fields == ev


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

def test_the_ported_surface_is_the_references():
    assert obs.__all__ == ref_obs.__all__
    assert set(obs.MUTATION_STATS_SCHEMA) == set(ref_obs.MUTATION_STATS_SCHEMA)
    for key, field in obs.MUTATION_STATS_SCHEMA.items():
        assert field.type is ref_obs.MUTATION_STATS_SCHEMA[key].type, key
    for name in dir(ref_obs):
        if name.startswith("on_") or name.isupper():
            assert hasattr(obs, name), name
    def instruments(o):
        return {m for m in o.REGISTRY.snapshot()["metrics"]
                if m.startswith("repro_")}

    assert instruments(obs) == instruments(ref_obs)


def _serve_sequence(p):
    """One served sequence: chunked queries over four engines, a budgeted
    chunk, a shed chunk, mutations through a compaction, more queries."""
    rng = np.random.default_rng(11)
    T = rng.standard_normal((300, 8)).astype(np.float32)
    U = rng.standard_normal((10, 8)).astype(np.float32)
    srv = p.server(T, max_batch=4, block_size=32, delta_capacity=8)
    for method in ("naive", "norm", "bta", "ta"):
        srv.query(U, 5, method=method)
    srv.query(U[:4], 5, method="norm", budget=3)
    srv.query(U[:2], 5, method="bta", deadline_ms=0.0)
    srv.add_targets(rng.standard_normal((9, 8)).astype(np.float32))
    srv.delete_targets([3, 4])
    srv.update_targets([7], rng.standard_normal((1, 8)).astype(np.float32))
    srv.query(U, 5, method="bta")
    return srv


def _series_keys(snap):
    """``repro_`` metric name -> the label sets of its series."""
    return {name: sorted(tuple(sorted(s["labels"].items()))
                         for s in m["series"])
            for name, m in snap["metrics"].items()
            if name.startswith("repro_")}


def test_same_served_sequence_same_snapshot_and_prom_names():
    """Both servers, one sequence: the same instruments, the same series
    (label sets) in every one but the compile counter — jit traces in the
    reference, kernel library loads (none on the CPU) in the port — each
    snapshot valid under both schemas, the same Prometheus sample names,
    and the same mutation_stats."""
    snaps, proms, stats = {}, {}, {}
    for name, p in PKGS.items():
        p.obs.reset()
        p.obs.set_enabled(True)
        srv = _serve_sequence(p)
        snaps[name] = p.obs.REGISTRY.snapshot()
        proms[name] = p.obs.parse_prom_text(p.obs.REGISTRY.render_prom())
        stats[name] = srv.mutation_stats
        p.obs.reset()
    traces = "repro_engine_traces_total"
    got, want = _series_keys(snaps["port"]), _series_keys(snaps["reference"])
    assert set(got) == set(want)
    for metric in set(want) - {traces}:
        assert got[metric] == want[metric], metric
    assert got[traces] == []
    for snap in snaps.values():
        obs.validate_snapshot(snap)
        ref_obs.validate_snapshot(snap)

    def names(samples):
        return {s for s in samples
                if s.startswith("repro_") and not s.startswith(traces)}

    assert names(proms["port"]) == names(proms["reference"])
    for key in ("repro_queries_total", "repro_scored_total",
                "repro_depth_total", "repro_shed_total",
                "repro_compaction_events_total", "repro_epoch_bumps_total"):
        for sample in (s for s in proms["reference"] if s.startswith(key)):
            assert proms["port"][sample] == proms["reference"][sample], sample
    timed = {"compaction_s_total", "last_compaction_s"}
    assert {k: v for k, v in stats["port"].items() if k not in timed} == {
        k: v for k, v in stats["reference"].items() if k not in timed}
