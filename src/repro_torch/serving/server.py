"""Top-K query serving: the paper's inference engine as a service layer.

``TopKServer`` owns a SEP-LR catalogue plus a shared
:class:`repro_torch.core.engines.EngineContext` on a device and serves
batched queries through any engine of the registry, addressed by name
(``bta`` — the default, alias ``blocked`` — ``ta``, the paper's
Threshold Algorithm, alias ``threshold``, ``naive``, ``norm``,
``topk_mips``, alias ``pallas``, the host oracles ``fagin`` and
``partial``, and ``auto``, which picks an engine per chunk with
:func:`repro_torch.core.engines.select_engine`). Requests are chunked by
``max_batch``; per-query pruning statistics (scores computed, depth) and
latencies are aggregated per engine that ran in :class:`ServeStats`.

Deadlines (``deadline_ms``, or :attr:`AdmissionPolicy.deadline_ms`) walk
each chunk down an admission ladder — the requested engine, then
``norm``, then a budgeted ``norm`` scan with certificates, then shed —
recorded under the requested method.

**Streaming mutations** (DESIGN.md §9): the catalogue is a
:class:`repro_torch.core.segments.SegmentedCatalogue` — an immutable base
snapshot (the EngineContext every engine runs against) plus a delta
buffer and tombstones. :meth:`TopKServer.add_targets` /
:meth:`delete_targets` / :meth:`update_targets` mutate it without an
index rebuild and without giving up exactness; a threshold-triggered
compaction folds the mutations into a fresh snapshot on the device under
the next version. A never-mutated server runs exactly the static path.
``n_shards > 0`` fronts the catalogue with the LSM ladder
(:class:`repro_torch.core.lsm.ShardedLsmCatalogue`): per-shard L1 runs
absorb most compactions as folds, with a full rebuild only when the tier
overflows.

Every seam reports into :mod:`repro_torch.obs`, as the reference's does.

``TwoStageRanker`` is the production recsys pattern: exact SEP-LR top-N
retrieval followed by full-model re-ranking of the N retrieved candidates.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core.engines import (CostTable, Engine, EngineContext,
                                      batch_bucket, engine_names, get_engine,
                                      note_pruning_metrics, select_engine)
from repro_torch.core.index import TopKIndex
from repro_torch.core.lsm import ShardedLsmCatalogue
from repro_torch.core.naive import TopKResult
from repro_torch.core.segments import SegmentedCatalogue
from repro_torch.core.seplr import SepLRModel
from repro_torch.core.strategies import sign_bucket_label

#: Ring length for per-batch latency percentiles: enough batches for a
#: stable p99, bounded so a long-lived server never grows its stats.
LATENCY_RING = 512


def _batch_hist() -> obs.Histogram:
    return obs.Histogram("serve_batch_latency_us",
                         "per-query us of one served batch",
                         buckets=obs.LATENCY_BUCKETS_US,
                         ring=LATENCY_RING)


def _request_hist() -> obs.Histogram:
    return obs.Histogram("serve_request_latency_us",
                         "enqueue->result us of one caller request",
                         buckets=obs.LATENCY_BUCKETS_US,
                         ring=LATENCY_RING)


@dataclasses.dataclass
class ServeStats:
    """Per-engine serving statistics.

    ``us_per_query`` is the lifetime mean; ``p50_us``/``p95_us``/``p99_us``
    are percentiles over a bounded ring of per-batch per-query latencies,
    and ``req_p50_us``/... over a ring of per-REQUEST latencies (one
    :meth:`TopKServer.query` call, all its chunks). The two rings are
    :class:`repro_torch.obs.Histogram` instances (log-scale buckets for
    export plus the bounded raw ring the exact percentiles read);
    ``lat_us_ring``/``req_lat_us_ring`` expose the rings. They are
    standalone instruments: ``obs.set_enabled(False)`` does not stop them.
    ``delta_scored`` counts scores spent on the streaming delta segments.
    ``sign_batches`` counts served batches per sign bucket (the list
    engines' batch specialisation). ``degradations`` counts the admission
    ladder's decisions by rung (``to_norm``, ``to_budgeted``, ``shed``)
    and ``n_uncertified`` the queries whose result holds an uncertified
    slot; both are kept on the REQUESTED method's stats, while the serve
    counters follow the engine that ran. Counter updates take a lock.
    """

    n_queries: int = 0
    n_scored: int = 0
    total_time_s: float = 0.0
    depth_sum: int = 0
    delta_scored: int = 0
    lat_hist: obs.Histogram = dataclasses.field(
        default_factory=_batch_hist, repr=False, compare=False)
    req_lat_hist: obs.Histogram = dataclasses.field(
        default_factory=_request_hist, repr=False, compare=False)
    sign_batches: Dict[str, int] = dataclasses.field(default_factory=dict)
    degradations: Dict[str, int] = dataclasses.field(default_factory=dict)
    n_uncertified: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def lat_us_ring(self):
        """The per-batch latency ring (the histogram's raw samples)."""
        return self.lat_hist.ring()

    @property
    def req_lat_us_ring(self):
        """The per-request latency ring."""
        return self.req_lat_hist.ring()

    @property
    def scores_per_query(self) -> float:
        return self.n_scored / max(self.n_queries, 1)

    @property
    def us_per_query(self) -> float:
        return 1e6 * self.total_time_s / max(self.n_queries, 1)

    def record_batch(self, n: int, n_scored: int, depth_sum: int,
                     dt_s: float, delta_scored: int = 0,
                     sign_label: str = "") -> None:
        """Fold one served batch in."""
        with self._lock:
            self.n_queries += n
            self.n_scored += n_scored
            self.depth_sum += depth_sum
            self.total_time_s += dt_s
            self.delta_scored += delta_scored
            if sign_label:
                self.sign_batches[sign_label] = (
                    self.sign_batches.get(sign_label, 0) + 1)
        self.lat_hist.observe(1e6 * dt_s / max(n, 1))

    def bump_degradation(self, rung: str) -> None:
        with self._lock:
            self.degradations[rung] = self.degradations.get(rung, 0) + 1

    def note_uncertified(self, n: int) -> None:
        with self._lock:
            self.n_uncertified += n

    def latency_percentile(self, q: float) -> float:
        """q-th percentile (0-100) of recent per-batch latencies, in us."""
        return self.lat_hist.percentile(q)

    @property
    def p50_us(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95_us(self) -> float:
        return self.latency_percentile(95.0)

    @property
    def p99_us(self) -> float:
        return self.latency_percentile(99.0)

    def record_request_latency(self, us: float) -> None:
        """One caller request completed ``us`` microseconds after it was
        submitted."""
        self.req_lat_hist.observe(float(us))

    def request_percentile(self, q: float) -> float:
        return self.req_lat_hist.percentile(q)

    @property
    def req_p50_us(self) -> float:
        return self.request_percentile(50.0)

    @property
    def req_p95_us(self) -> float:
        return self.request_percentile(95.0)

    @property
    def req_p99_us(self) -> float:
        return self.request_percentile(99.0)


@dataclasses.dataclass
class AdmissionPolicy:
    """Load/deadline policy for :meth:`TopKServer.query`.

    When a deadline is in force, each chunk walks a degradation ladder
    instead of queueing unboundedly: the REQUESTED engine if its predicted
    cost fits the remaining time, else ``norm`` (an exact scan), else a
    BUDGETED ``norm`` scan whose result carries per-item certificates
    (``TopKResult.upper``), else — deadline already blown, or the server
    over ``max_inflight`` — the chunk is SHED: sentinel values (``-inf``
    scores, ``-1`` ids, ``+inf`` certificate bounds: nothing certified),
    never a partial answer passed off as exact. Every downgrade and shed
    lands in :attr:`ServeStats.degradations` under the requested method.
    """

    #: default per-query deadline (None = no deadline: never degrade);
    #: ``query(deadline_ms=...)`` overrides it per call
    deadline_ms: Optional[float] = None
    #: concurrent chunks in flight before overload shedding kicks in
    max_inflight: int = 8
    #: scan budget (rows) of the "budgeted" rung
    degrade_budget: int = 64
    #: shed on overload/expiry (False = serve the budgeted rung instead)
    shed_on_overload: bool = True


def _to_host(res: TopKResult) -> TopKResult:
    return TopKResult(*(None if x is None else x.detach().cpu().numpy()
                        for x in res))


class TopKServer:
    """Exact top-K serving over a streaming catalogue on ``device``
    (``None`` = ``cuda``), under an :class:`AdmissionPolicy` (default: no
    deadline, at most 8 chunks in flight).

    ``delta_capacity``, ``compact_async`` and ``max_tombstones`` configure
    the :class:`SegmentedCatalogue` (``max_tombstones=None`` keeps its
    default, ``2 * delta_capacity``); ``n_shards > 0`` makes it a
    :class:`ShardedLsmCatalogue` of that many L1 runs, each of
    ``l1_capacity`` rows (``None``: its default). The cost table is shared
    by every context a compaction builds, so measurements survive
    snapshot swaps.
    """

    def __init__(self, model: SepLRModel, max_batch: int = 64,
                 block_size: int = 256, delta_capacity: int = 256,
                 compact_async: bool = False,
                 policy: Optional[AdmissionPolicy] = None, n_shards: int = 0,
                 l1_capacity: Optional[int] = None,
                 max_tombstones: Optional[int] = None,
                 cost_table: Optional[CostTable] = None, device=None):
        self.model = model
        self.device = resolve_device(device)
        self.cost_table = cost_table if cost_table is not None \
            else CostTable()
        tomb = {} if max_tombstones is None \
            else {"max_tombstones": max_tombstones}
        kw = dict(delta_capacity=delta_capacity,
                  compact_async=compact_async, block_size=block_size,
                  cost_table=self.cost_table, device=self.device, **tomb)
        if n_shards > 0:
            self.catalogue: SegmentedCatalogue = ShardedLsmCatalogue(
                model.targets, n_shards=n_shards, l1_capacity=l1_capacity,
                **kw)
        else:
            self.catalogue = SegmentedCatalogue(model.targets, **kw)
        self.max_batch = max_batch
        self.block_size = block_size
        self.stats: Dict[str, ServeStats] = {}
        self.policy = policy if policy is not None else AdmissionPolicy()
        # per-engine EWMA of per-query serve seconds: the ladder's FIRST
        # cost source (tests set entries to force a rung); an engine with
        # no entry falls back to the shared cost table, and one absent
        # from both predicts 0 (admit, then learn)
        self._cost_ewma: Dict[str, float] = {}
        self._admit_lock = threading.Lock()
        self._inflight = 0

    @property
    def ctx(self) -> EngineContext:
        """The CURRENT base snapshot's engine context (a compaction swaps
        in a fresh one under the next version)."""
        return self.catalogue.snapshot.ctx

    @property
    def index(self) -> TopKIndex:
        return self.ctx.index

    @property
    def trace_counts(self) -> Dict[str, int]:
        """Kernel library loads (the port's compiles) per engine on the
        current snapshot; the catalogue's tail is plain PyTorch and
        compiles nothing."""
        return dict(self.ctx.trace_counts)

    @staticmethod
    def available_engines() -> List[str]:
        """Registry names accepted by :meth:`query`'s ``method=``."""
        return engine_names()

    def warmup(self, k: int, batch_sizes=None, engines=None,
               budgets=None) -> "TopKServer":
        """Build every engine's lazy state ahead of traffic (index,
        layouts, kernel catalogue, the CUDA library) and prime the cost
        table, per sign bucket and, with ``budgets``, per budgeted
        variant (see :meth:`EngineContext.warmup`); then ready the
        over-fetched ``k`` the tombstoned path fetches, and record the
        warm spec that each compaction readies its new snapshot with
        before the swap."""
        sizes = tuple(batch_sizes) if batch_sizes else (1, self.max_batch)
        self.ctx.warmup(k, batch_sizes=sizes, engines=engines,
                        budgets=budgets)
        self.catalogue.warm(k, batch_sizes=sizes, engines=engines,
                            budgets=budgets)
        self.catalogue.set_warm_spec(k, sizes, engines, budgets=budgets)
        return self

    # -- streaming mutations (DESIGN.md §9) ---------------------------------

    def add_targets(self, rows) -> np.ndarray:
        """Stream new items into the catalogue; returns their global ids."""
        return self.catalogue.add_targets(rows)

    def delete_targets(self, gids) -> None:
        """Tombstone items; queries exclude them immediately and exactly."""
        self.catalogue.delete_targets(gids)

    def update_targets(self, gids, rows) -> None:
        """Replace item factors in place (same global ids)."""
        self.catalogue.update_targets(gids, rows)

    @property
    def mutation_stats(self) -> Dict[str, float]:
        """Delta/compaction counters, built by
        :func:`repro_torch.obs.build_mutation_stats` against
        :data:`repro_torch.obs.MUTATION_STATS_SCHEMA` (which documents
        every key and raises on drift)."""
        cat = self.catalogue
        return obs.build_mutation_stats({
            "n_inserts": cat.stats.n_inserts,
            "n_deletes": cat.stats.n_deletes,
            "n_updates": cat.stats.n_updates,
            "n_compactions": cat.stats.n_compactions,
            "n_failed_compactions": cat.stats.n_failed_compactions,
            "max_delta_occupancy": cat.stats.max_delta_occupancy,
            "delta_occupancy": cat.delta_occupancy,
            "n_tombstones": cat.n_tombstones,
            "snapshot_version": cat.version,
            "num_live": cat.num_live,
            "engine_compiles_total": cat.stats.engine_compiles_total,
            "engine_compiles_per_compaction": (
                cat.stats.engine_compiles_total
                / max(cat.stats.n_compactions, 1)),
            "headroom_compiles_total": cat.stats.headroom_compiles_total,
            "compaction_s_total": cat.stats.compaction_s_total,
            "last_compaction_s": cat.stats.last_compaction_s,
            "n_build_retries": cat.stats.n_build_retries,
            "n_forced_sync_compactions": cat.stats.n_forced_sync_compactions,
            "n_stuck_builds": cat.stats.n_stuck_builds,
            "max_l0_chain": cat.stats.max_l0_chain,
            "l0_chain_len": cat.l0_chain_len,
            "consecutive_build_failures": cat.consecutive_build_failures,
            "current_backoff_s": cat.current_backoff_s,
            "retry_pending": int(cat.retry_pending),
            # the LSM ladder's keys (neutral on the single-level catalogue)
            "n_shards": cat.n_shards,
            "l1_rows": cat.l1_rows,
            "n_l1_folds": cat.stats.n_l1_folds,
            "n_failed_l1_folds": cat.stats.n_failed_l1_folds,
            "n_l1_fold_retries": cat.stats.n_l1_fold_retries,
            "l1_fold_s_total": cat.stats.l1_fold_s_total,
            "consecutive_fold_failures": cat.consecutive_fold_failures,
            "fold_backoff_s": cat.fold_backoff_s,
        })

    def _record(self, method: str, res: TopKResult, dt: float,
                n: int, delta_scored: int = 0, sign_label: str = "") -> None:
        s = self.stats.setdefault(method, ServeStats())
        n_scored = int(np.sum(res.n_scored))
        depth_sum = int(np.sum(res.depth))
        s.record_batch(n, n_scored, depth_sum, dt, int(delta_scored) * n,
                       sign_label)
        note_pruning_metrics(method, n, n_scored, depth_sum,
                             self.catalogue.num_live, 1e6 * dt / max(n, 1),
                             sign_label)

    def _note_certificates(self, req_stats: ServeStats, engine_name: str,
                           bud: int, res: TopKResult) -> None:
        """Certificate accounting for one budgeted batch: the queries whose
        result holds an uncertified slot (``upper - value > 0`` at a real
        id), and the registry's certified fraction and mean uncertified
        gap per (engine, budget bucket)."""
        gaps = res.upper[:, None] - res.values
        valid = res.indices >= 0
        unc = np.logical_and(gaps > 0, valid)
        n_unc_queries = int(np.sum(np.any(unc, axis=1)))
        req_stats.note_uncertified(n_unc_queries)
        n_unc = int(np.sum(unc))
        frac = 1.0 - n_unc / max(int(np.sum(valid)), 1)
        mean_gap = float(gaps[unc].mean()) if n_unc else 0.0
        obs.on_uncertified(engine_name, n_unc_queries)
        obs.on_certificates(engine_name, batch_bucket(int(bud)), frac,
                            mean_gap, n_unc > 0)

    def _shed_result(self, n: int, k: int) -> TopKResult:
        """Sentinel result for a shed chunk: explicitly nothing — ``-inf``
        scores, ``-1`` ids, ``+inf`` certificate bounds (no slot
        certified)."""
        return TopKResult(
            np.full((n, k), -np.inf, np.float32),
            np.full((n, k), -1, np.int32),
            np.zeros((n,), np.int32),
            np.zeros((n,), np.int32),
            upper=np.full((n,), np.inf, np.float32))

    def _admit(self, eng: Engine, n: int, remaining_s: Optional[float]):
        """The ladder's rung for one ``n``-query chunk: ``(engine or None,
        budget, rung)``, None meaning shed. Costs come from
        :attr:`_cost_ewma`, else from the cost table at this chunk's
        batch bucket (warmup primes it), else 0."""
        pol = self.policy
        if remaining_s is None:
            return eng, None, "full"
        bucket = batch_bucket(max(n, 1))

        def cost(name: str) -> float:
            c = self._cost_ewma.get(name)
            if c is None:
                c = self.cost_table.predict(name, bucket, "")
            return (c or 0.0) * n

        if remaining_s <= 0.0:
            if pol.shed_on_overload:
                return None, None, "shed"
            return get_engine("norm"), pol.degrade_budget, "to_budgeted"
        if cost(eng.name) <= remaining_s:
            return eng, None, "full"
        if eng.name != "norm" and cost("norm") <= remaining_s:
            return get_engine("norm"), None, "to_norm"
        return get_engine("norm"), pol.degrade_budget, "to_budgeted"

    def query(self, U, k: int, method: str = "bta",
              budget: Optional[int] = None,
              deadline_ms: Optional[float] = None) -> TopKResult:
        """U: [B, R] (or [R]). Returns a host (numpy) ``TopKResult``
        batched like U.

        ``method`` is any registry name or alias from
        :meth:`available_engines`; unknown names raise ``ValueError``
        listing the registry. ``auto`` picks an engine per chunk
        (:func:`select_engine`, reading a tensor chunk to the host once);
        its serve counters go to the engine that ran. ``budget`` caps the
        scan of budget-capable engines (norm-order rows for ``norm``,
        list depth for ``bta``, rounds for ``ta``); the result's ``upper``
        then bounds every un-scanned item. Each chunk of ``max_batch``
        queries is timed on the host clock up to its result's arrival on
        the host, and its per-query cost recorded in the cost table (and
        :attr:`_cost_ewma`), under ``"<engine>@budget"`` when budgeted.

        **Deadlines** (``deadline_ms``, else ``policy.deadline_ms``): each
        chunk walks the :class:`AdmissionPolicy` ladder on the time the
        request has left — requested engine, ``norm``, budgeted ``norm``,
        shed — after the overload check (``policy.max_inflight`` chunks in
        flight). Rungs other than ``full`` count in the requested method's
        :attr:`ServeStats.degradations`.

        Validation: non-positive ``k``/``budget``, negative
        ``deadline_ms``, wrong-rank or >2-D ``U``, and non-finite HOST
        query values raise ``ValueError``.
        """
        engine = get_engine(method)
        if int(k) <= 0:
            raise ValueError(f"k must be a positive int, got {k!r}")
        if budget is not None and int(budget) <= 0:
            raise ValueError(
                f"budget must be a positive int or None, got {budget!r}")
        if deadline_ms is not None and float(deadline_ms) < 0:
            raise ValueError(
                f"deadline_ms must be >= 0 or None, got {deadline_ms!r}")
        # device-resident inputs stay where they are; host inputs are
        # checked for finiteness and moved per chunk
        if isinstance(U, torch.Tensor):
            U_all = torch.atleast_2d(U)
        else:
            U_all = np.atleast_2d(np.asarray(U, np.float32))
        if U_all.ndim != 2:
            raise ValueError(
                f"U must be [B, R] or [R], got shape {tuple(U_all.shape)}")
        rank = self.catalogue.rank
        if U_all.shape[1] != rank:
            raise ValueError(
                f"query rank {U_all.shape[1]} != catalogue rank {rank}")
        if isinstance(U_all, np.ndarray) and not np.all(np.isfinite(U_all)):
            bad = int(np.argwhere(~np.isfinite(U_all).all(axis=1))[0, 0])
            raise ValueError(f"query row {bad} contains NaN/Inf values")
        if deadline_ms is None:
            deadline_ms = self.policy.deadline_ms
        t_admit = time.perf_counter()
        req_stats = self.stats.setdefault(engine.name, ServeStats())
        outs = []
        for i in range(0, U_all.shape[0], self.max_batch):
            chunk = U_all[i: i + self.max_batch]
            n = chunk.shape[0]
            eng = (select_engine(self.ctx, chunk)
                   if engine.name == "auto" else engine)
            # admission: overload first (a counter check), then the
            # deadline ladder on the time this request has left
            with self._admit_lock:
                overloaded = (self._inflight >= self.policy.max_inflight
                              and self.policy.shed_on_overload)
                self._inflight += 1
            try:
                if overloaded:
                    run_eng, bud, rung = None, None, "shed"
                else:
                    remaining = None if deadline_ms is None else (
                        deadline_ms / 1e3 - (time.perf_counter() - t_admit))
                    run_eng, bud, rung = self._admit(eng, n, remaining)
                if rung != "full":
                    req_stats.bump_degradation(rung)
                    obs.on_degradation(engine.name, rung)
                if run_eng is None:
                    req_stats.note_uncertified(n)
                    obs.on_uncertified(engine.name, n)
                    outs.append(self._shed_result(n, int(k)))
                    continue
                if bud is None:
                    bud = budget  # the caller's budget, not a downgrade
                # the chunk's sign bucket (engines with a batch
                # specialisation only): worked out once, for the run and
                # the per-bucket stats
                t0 = time.perf_counter()
                bcfg = (run_eng.batch_config(self.ctx, chunk)
                        if run_eng.batch_config is not None else ())
                label = (sign_bucket_label(bcfg)
                         if run_eng.batch_config is not None else "")
                res, info = self.catalogue.query(run_eng, chunk, k,
                                                 budget=bud, bcfg=bcfg)
                res = _to_host(res)
                dt = time.perf_counter() - t0
            finally:
                with self._admit_lock:
                    self._inflight -= 1
            if res.upper is None:
                # an exact engine without a bound: the vacuous one
                res = res._replace(upper=np.full((n,), -np.inf, np.float32))
            if bud is not None:
                self._note_certificates(req_stats, run_eng.name, bud, res)
            # cost model: per-query seconds per (engine, budgeted?), as an
            # EWMA for the ladder and per (bucket, sign) for the router
            key = run_eng.name if bud is None else f"{run_eng.name}@budget"
            per_q = dt / max(n, 1)
            prev = self._cost_ewma.get(key)
            self._cost_ewma[key] = (per_q if prev is None
                                    else 0.8 * prev + 0.2 * per_q)
            self.cost_table.observe(key, batch_bucket(n), label, per_q)
            self._record(run_eng.name, res, dt, n, info.delta_scored,
                         sign_label=label)
            outs.append(res)
        req_us = 1e6 * (time.perf_counter() - t_admit)
        req_stats.record_request_latency(req_us)
        obs.on_request_done(engine.name, req_us)
        return TopKResult(*(np.concatenate(xs, axis=0) for xs in zip(*outs)))


class TwoStageRanker:
    """Exact SEP-LR retrieval -> full-model re-rank.

    rerank_fn(query_batch, candidate_ids) -> scores of the retrieved set.
    The retrieval engine is addressed by registry name, as in
    :meth:`TopKServer.query`. ``U`` may be the query tower's output on the
    server's device: it is retrieved there, with no host round trip.
    """

    def __init__(self, retrieval: TopKServer,
                 rerank_fn: Callable[[Dict, np.ndarray], np.ndarray],
                 retrieve_n: int = 100):
        self.retrieval = retrieval
        self.rerank_fn = rerank_fn
        self.retrieve_n = retrieve_n

    def rank(self, query_batch: Dict, U, k: int, method: str = "bta"):
        get_engine(method)  # fail fast on unknown engine names
        res = self.retrieval.query(U, self.retrieve_n, method=method)
        cand = np.asarray(res.indices)                       # [B, N]
        rerank = self.rerank_fn(query_batch, cand)           # [B, N]
        order = np.argsort(-rerank, axis=1)[:, :k]
        return (np.take_along_axis(cand, order, axis=1),
                np.take_along_axis(rerank, order, axis=1))
