"""Unified observability layer (DESIGN.md §14), the port's own copy of
the reference's stdlib-only ``obs`` package: the same instruments, the
same ``repro_``-prefixed metric names and the same ``on_*`` helpers.

Three process-wide defaults, one switch:

* :data:`REGISTRY` — the metrics registry (counters / gauges /
  log-scale histograms; JSON ``snapshot()`` + Prometheus
  ``render_prom()`` exporters);
* :data:`TRACER` — per-request span trees with a sampling knob and a
  bounded store;
* :data:`JOURNAL` — the bounded structured event journal (compactions,
  faults, degradations, invalidations, epoch bumps, kernel loads).

``set_enabled(False)`` turns all three into no-op branches — the
baseline the reference's overhead benchmark (``benchmarks/obs_overhead.py``)
compares against.

The ``on_*`` helpers below are the ONLY thing production code calls:
each is one function call at the instrumentation seam, early-outs when
disabled, and owns the mapping from a domain event to instrument
updates + journal records. Keeping the mapping here (rather than at the
call sites) keeps engine/catalogue/serving code one line per seam and
makes the full instrument inventory reviewable in one file.

Label/metric naming: every metric is ``repro_``-prefixed; label axes
mirror the compile-cache axes (``engine``, ``bucket``, ``sign``) plus
the admission axes (``rung``, ``budget_bucket``) so a dashboard slices
along the same lines the system specialises along.
"""

from __future__ import annotations

from repro_torch.obs.events import Event, EventJournal
from repro_torch.obs.metrics import (
    Counter,
    FRACTION_BUCKETS,
    GAP_BUCKETS,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_US,
    MetricsRegistry,
    SECONDS_BUCKETS,
    SIZE_BUCKETS,
    log2_buckets,
    parse_prom_text,
    validate_snapshot,
)
from repro_torch.obs.schema import (
    MUTATION_STATS_SCHEMA,
    StatField,
    build_mutation_stats,
)
from repro_torch.obs.trace import Span, Trace, Tracer

__all__ = [
    "REGISTRY", "JOURNAL", "TRACER", "set_enabled", "enabled", "reset",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "EventJournal",
    "Event", "Tracer", "Trace", "Span", "log2_buckets",
    "validate_snapshot", "parse_prom_text", "build_mutation_stats",
    "MUTATION_STATS_SCHEMA", "StatField",
    "LATENCY_BUCKETS_US", "SECONDS_BUCKETS", "FRACTION_BUCKETS",
    "GAP_BUCKETS", "SIZE_BUCKETS",
]

#: process-wide defaults — the engine/catalogue/serving seams record here
REGISTRY = MetricsRegistry()
JOURNAL = EventJournal(capacity=4096)
TRACER = Tracer(capacity=256, sample_rate=1.0)


def set_enabled(on: bool) -> None:
    """Master switch for the default registry, tracer and journal."""
    REGISTRY.enabled = TRACER.enabled = JOURNAL.enabled = bool(on)


def enabled() -> bool:
    return REGISTRY.enabled


def reset() -> None:
    """Clear every default store (instrument definitions survive) —
    test/benchmark isolation."""
    REGISTRY.reset()
    JOURNAL.clear()
    TRACER.clear()


# ---------------------------------------------------------------------------
# Instrument inventory
# ---------------------------------------------------------------------------

ENGINE_TRACES = REGISTRY.counter(
    "repro_engine_traces_total",
    "CUDA kernel library loads (the port's compiles: each miss of "
    "kernels._build.load), per library.",
    labels=("engine",))
QUERIES = REGISTRY.counter(
    "repro_queries_total", "Queries served, per engine that ran.",
    labels=("engine",))
SCORED = REGISTRY.counter(
    "repro_scored_total",
    "Candidate scores computed (the paper's cost metric), per engine.",
    labels=("engine",))
DEPTH = REGISTRY.counter(
    "repro_depth_total", "Scan depth consumed (list rows), per engine.",
    labels=("engine",))
SCORED_FRACTION = REGISTRY.histogram(
    "repro_scored_fraction",
    "Per-batch mean fraction of the live catalogue scored — the "
    "pruning-efficiency claim, live.",
    labels=("engine",), buckets=FRACTION_BUCKETS)
BATCH_LATENCY = REGISTRY.histogram(
    "repro_batch_latency_us",
    "Per-query microseconds of one served batch (dispatch->harvest).",
    labels=("engine",), buckets=LATENCY_BUCKETS_US)
REQUEST_LATENCY = REGISTRY.histogram(
    "repro_request_latency_us",
    "Per-request enqueue->result microseconds (queue wait included).",
    labels=("engine",), buckets=LATENCY_BUCKETS_US)
QUEUE_WAIT = REGISTRY.histogram(
    "repro_queue_wait_us",
    "Microseconds a request waited in the coalescing queue before its "
    "micro-batch formed.",
    labels=(), buckets=LATENCY_BUCKETS_US)
BATCH_SIZE = REGISTRY.histogram(
    "repro_batch_size", "Coalesced micro-batch sizes (exact, pre-pad).",
    labels=(), buckets=SIZE_BUCKETS)
SIGN_BATCHES = REGISTRY.counter(
    "repro_sign_batches_total",
    "Batches served per sign bucket (the DESIGN.md §11 compile axis).",
    labels=("engine", "sign"))
DEGRADATIONS = REGISTRY.counter(
    "repro_degradations_total",
    "Admission-ladder downgrades, per REQUESTED engine and rung.",
    labels=("engine", "rung"))
SHED = REGISTRY.counter(
    "repro_shed_total", "Requests shed (sentinel results).", labels=())
UNCERTIFIED = REGISTRY.counter(
    "repro_uncertified_total",
    "Queries whose result carried >= 1 uncertified slot.",
    labels=("engine",))
CERTIFIED_FRACTION = REGISTRY.histogram(
    "repro_certified_fraction",
    "Per-batch fraction of result slots provably in the true top-K "
    "(certificate gap <= 0), per engine and budget bucket.",
    labels=("engine", "budget_bucket"), buckets=FRACTION_BUCKETS)
UNCERTIFIED_GAP = REGISTRY.histogram(
    "repro_uncertified_gap",
    "Per-batch mean certificate gap over UNCERTIFIED slots (score "
    "units; how far from provable the halted scan stopped).",
    labels=("engine", "budget_bucket"), buckets=GAP_BUCKETS)
CACHE_LOOKUPS = REGISTRY.counter(
    "repro_cache_lookups_total", "Result-cache lookups by outcome.",
    labels=("outcome",))
CACHE_INVALIDATIONS = REGISTRY.counter(
    "repro_cache_invalidations_total",
    "Result-cache full invalidations (catalogue listener).", labels=())
COMPACTIONS = REGISTRY.counter(
    "repro_compaction_events_total",
    "Compaction state-machine transitions (start/success/fail/retry/"
    "retry_scheduled/forced_sync/stuck).",
    labels=("event",))
COMPACTION_SECONDS = REGISTRY.histogram(
    "repro_compaction_seconds", "Successful compaction build seconds.",
    labels=(), buckets=SECONDS_BUCKETS)
EPOCH_BUMPS = REGISTRY.counter(
    "repro_epoch_bumps_total",
    "Mutation-epoch bumps by kind (insert/update/delete/swap).",
    labels=("kind",))
FAULTS_FIRED = REGISTRY.counter(
    "repro_faults_fired_total", "Armed fault-seam triggers, per point.",
    labels=("point",))
COST_TABLE_US = REGISTRY.gauge(
    "repro_cost_table_us",
    "Measured per-query cost EWMA, per (engine, batch bucket, sign) — "
    "the serving router's table, exported live.",
    labels=("engine", "bucket", "sign"))


# ---------------------------------------------------------------------------
# Wiring helpers (the one-liners production seams call)
# ---------------------------------------------------------------------------

def on_engine_trace(engine: str, bcfg: tuple = ()) -> None:
    """A kernel library was loaded (built and bound) — the port's compile,
    fired by ``repro_torch.kernels._build.load`` on each miss; ``engine``
    names the library."""
    if not REGISTRY.enabled:
        return
    ENGINE_TRACES.inc(engine=engine)
    JOURNAL.emit("engine.trace", engine=engine,
                 sign=str(bcfg) if bcfg else "")


def on_batch_served(engine: str, n: int, n_scored: int, depth_sum: int,
                    m_live: int, per_query_us: float,
                    sign_label: str = "") -> None:
    """One batch harvested: pruning-efficiency + latency metrics."""
    if not REGISTRY.enabled:
        return
    QUERIES.inc(n, engine=engine)
    SCORED.inc(n_scored, engine=engine)
    DEPTH.inc(depth_sum, engine=engine)
    if m_live > 0 and n > 0:
        SCORED_FRACTION.observe(n_scored / (n * m_live), engine=engine)
    BATCH_LATENCY.observe(per_query_us, engine=engine)
    if sign_label:
        SIGN_BATCHES.inc(engine=engine, sign=sign_label)


def on_request_done(engine: str, us: float) -> None:
    if not REGISTRY.enabled:
        return
    REQUEST_LATENCY.observe(us, engine=engine)


def on_queue_wait(us: float) -> None:
    if not REGISTRY.enabled:
        return
    QUEUE_WAIT.observe(us)


def on_batch_formed(n: int) -> None:
    if not REGISTRY.enabled:
        return
    BATCH_SIZE.observe(n)


def on_degradation(engine: str, rung: str) -> None:
    """An admission-ladder downgrade decision (recorded under the
    REQUESTED engine, same accounting as ``ServeStats.degradations``)."""
    if not REGISTRY.enabled:
        return
    DEGRADATIONS.inc(engine=engine, rung=rung)
    if rung == "shed":
        SHED.inc()
    JOURNAL.emit("admission.degrade", engine=engine, rung=rung)


def on_uncertified(engine: str, n: int) -> None:
    if not REGISTRY.enabled or n <= 0:
        return
    UNCERTIFIED.inc(n, engine=engine)


def on_certificates(engine: str, budget_bucket: int,
                    certified_fraction: float,
                    mean_uncertified_gap: float,
                    any_uncertified: bool) -> None:
    """One budgeted batch's certificate summary (pinned against
    ``certificate_gaps`` ground truth by tests/test_obs.py)."""
    if not REGISTRY.enabled:
        return
    b = str(int(budget_bucket))
    CERTIFIED_FRACTION.observe(certified_fraction, engine=engine,
                               budget_bucket=b)
    if any_uncertified:
        UNCERTIFIED_GAP.observe(mean_uncertified_gap, engine=engine,
                                budget_bucket=b)


def on_cache_lookup(hit: bool) -> None:
    if not REGISTRY.enabled:
        return
    CACHE_LOOKUPS.inc(outcome="hit" if hit else "miss")


def on_cache_invalidated() -> None:
    """Result-cache flush. May run under the catalogue lock (the
    invalidation-listener path) — journal emission is lock-safe."""
    if not REGISTRY.enabled:
        return
    CACHE_INVALIDATIONS.inc()
    JOURNAL.emit("cache.invalidate")


def on_compaction(event: str, **fields) -> None:
    """One compaction state-machine transition; ``fields`` carry the
    join keys the producer knows (version, epoch, chain_len, ...)."""
    if not REGISTRY.enabled:
        return
    COMPACTIONS.inc(event=event)
    if event == "success" and "duration_s" in fields:
        COMPACTION_SECONDS.observe(fields["duration_s"])
    JOURNAL.emit(f"compaction.{event}", **fields)


def on_epoch_bump(kind: str, version: int, epoch: int) -> None:
    """A visible mutation bumped the epoch (called under the catalogue
    lock — emission must stay reentrancy-free, which it is)."""
    if not REGISTRY.enabled:
        return
    EPOCH_BUMPS.inc(kind=kind)
    JOURNAL.emit("epoch.bump", mutation=kind, version=version,
                 epoch=epoch)


def on_fault_fired(point: str) -> None:
    if not REGISTRY.enabled:
        return
    FAULTS_FIRED.inc(point=point)
    JOURNAL.emit("fault.fired", point=point)


def on_cost_observation(engine: str, bucket: int, label: str,
                        per_query_s: float) -> None:
    """CostTable EWMA update — exported live as a gauge."""
    if not REGISTRY.enabled:
        return
    COST_TABLE_US.set(1e6 * per_query_s, engine=engine,
                      bucket=str(int(bucket)), sign=label)
