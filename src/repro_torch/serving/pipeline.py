"""Async micro-batching serving pipeline (DESIGN.md §13), on CUDA events.

The port of the reference's ``serving/pipeline.py``. The batched scans
are several times cheaper per query at B >= 8, but only when someone
HANDS the server a large batch. ``AsyncTopKServer`` manufactures those
batches from independent single-query requests, wrapping a
:class:`repro_torch.serving.server.TopKServer` with

* a thread-safe request queue that COALESCES arrivals into the
  power-of-two batch buckets. A request waits at most its flush deadline
  (``flush_ms``, capped at half its remaining admission-deadline
  headroom) before its partial bucket dispatches, and does not wait AT
  ALL while the device pipeline is idle;
* a two-stage pipeline that overlaps HOST work (queue pop, cache probe,
  sign-bucketing, batch assembly, result unpadding) with the DEVICE work
  of the previous micro-batch. The dispatcher thread runs
  ``catalogue.query`` on the current CUDA stream, the one every producer
  of the catalogue's tensors uses (:mod:`repro_torch.core.segments`),
  records a CUDA event after it and moves on; the harvester thread is
  the only place that waits (``event.synchronize()``) and only then
  copies the result to the host, on a stream of its own. A bounded
  harvest queue (``pipeline_depth``) back-pressures the dispatcher. On
  the CPU there are no events; the code path is otherwise the same;
* MEASURED-COST dispatch: ``method="auto"`` picks the engine per
  micro-batch from the shared :class:`repro_torch.core.engines.CostTable`
  through :func:`repro_torch.core.engines.select_engine`;
* a head-query RESULT CACHE keyed ``(query bytes, k, cache token)``, the
  token being the catalogue's ``(snapshot version, mutation epoch)``
  captured BEFORE the scan dispatches: any visible mutation changes it,
  and the catalogue's invalidation listener empties the cache outright.

The admission ladder (:class:`repro_torch.serving.server.AdmissionPolicy`)
runs at DISPATCH time per micro-batch against the batch's tightest
remaining deadline; a shed batch returns the explicit sentinel.

Host reads inside a dispatch (the list engines' one read a step, the
tombstone ladder's one read a rung, ``auto``'s reads of the query chunk)
block the dispatcher, as they must: they stay where they are, and cost
overlap, not exactness. A dispatcher or harvester exception fails its
batch's futures; :meth:`AsyncTopKServer.close` joins both threads with a
timeout and re-raises an exception that ended a thread.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engines import (auto_candidates, batch_bucket,
                                      get_engine, select_engine)
from repro_torch.core.naive import TopKResult
from repro_torch.core.seplr import SepLRModel
from repro_torch.core.strategies import sign_bucket_label
from repro_torch.serving.server import (AdmissionPolicy, ServeStats,
                                        TopKServer, _to_host)

#: default time a request may sit in a partial bucket before it flushes
DEFAULT_FLUSH_MS = 2.0
#: micro-batches in flight (dispatched, not yet harvested) before the
#: dispatcher blocks — stage overlap needs 2; more only adds queue delay
DEFAULT_PIPELINE_DEPTH = 2
#: result-cache entries kept (LRU); one entry is one (query, k) row
DEFAULT_CACHE_CAPACITY = 4096
#: seconds :meth:`AsyncTopKServer.close` waits for each thread to end
CLOSE_TIMEOUT_S = 120.0


class ResultCache:
    """LRU cache of per-request exact results, token-scoped.

    Keys are ``(query bytes, k, token)`` with ``token`` the catalogue's
    ``(version, epoch)`` :meth:`~repro_torch.core.segments.SegmentedCatalogue.
    cache_token` captured before the scan that produced the value was
    dispatched. Because every visible mutation changes the token, a
    lookup under the CURRENT token can only hit entries whose contents
    are the current contents — the cache cannot serve across a snapshot
    version bump (or a delta append, which bumps the epoch half). The
    catalogue's invalidation listener additionally calls
    :meth:`invalidate` so dead-token entries do not linger in memory.

    Thread-safe; only EXACT results are inserted (a degraded or
    budgeted answer is a statement about one moment's load, not about
    the query).
    """

    def __init__(self, capacity: int = DEFAULT_CACHE_CAPACITY):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.n_invalidations = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def lookup(self, key: tuple) -> Optional[tuple]:
        with self._lock:
            row = self._data.get(key)
            if row is None:
                self.misses += 1
            else:
                self._data.move_to_end(key)
                self.hits += 1
        obs.on_cache_lookup(row is not None)
        return row

    def insert(self, key: tuple, row: tuple) -> None:
        with self._lock:
            self._data[key] = row
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def invalidate(self) -> None:
        """Drop everything. Runs as the catalogue's invalidation
        listener — possibly under the catalogue lock (synchronous
        compaction), so it must not call back into the catalogue.
        (The obs journal emission below holds only the journal's own
        lock, so it keeps that guarantee.)"""
        with self._lock:
            self._data.clear()
            self.n_invalidations += 1
        obs.on_cache_invalidated()


class _Request:
    """One submitted query riding the pipeline."""

    __slots__ = ("u", "k", "method", "budget", "deadline_s", "t_enqueue",
                 "flush_by", "event", "row", "error", "trace")

    def __init__(self, u: np.ndarray, k: int, method: str,
                 budget: Optional[int], deadline_ms: Optional[float],
                 flush_ms: float):
        now = time.perf_counter()
        self.u = u
        self.k = int(k)
        self.method = method
        self.budget = budget
        self.deadline_s = (None if deadline_ms is None
                           else now + float(deadline_ms) / 1e3)
        self.t_enqueue = now
        # a deadline halves the coalescing allowance: the request must
        # keep headroom to actually RUN after its flush fires
        wait = flush_ms / 1e3
        if deadline_ms is not None:
            wait = min(wait, 0.5 * float(deadline_ms) / 1e3)
        self.flush_by = now + wait
        self.event = threading.Event()
        self.row: Optional[tuple] = None
        self.error: Optional[BaseException] = None
        #: sampled obs trace (a :class:`repro_torch.obs.Trace`) or None — set
        #: by submit(); stage threads stamp spans onto it as the request
        #: rides the pipeline
        self.trace = None

    def fulfill(self, row: tuple) -> None:
        self.row = row
        self.event.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.event.set()


class PendingResult:
    """Handle returned by :meth:`AsyncTopKServer.submit`."""

    def __init__(self, req: _Request):
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    def result(self, timeout: Optional[float] = None) -> TopKResult:
        """Block until the request completes; returns a ``[1, k]``
        batched :class:`TopKResult` (same shape contract as
        ``TopKServer.query`` on a single query)."""
        if not self._req.event.wait(timeout):
            raise TimeoutError("result not ready within timeout")
        if self._req.error is not None:
            raise self._req.error
        vals, ids, nsc, depth, upper = self._req.row
        return TopKResult(vals[None], ids[None], nsc[None], depth[None],
                          upper=upper[None])


class PipelineStats:
    """Counters for the queue/pipeline layer (engine-level serve stats
    stay on :attr:`AsyncTopKServer.stats`, per requested method)."""

    def __init__(self) -> None:
        self.n_requests = 0
        self.n_batches = 0
        self.n_cached = 0
        self.n_shed = 0
        #: dispatched micro-batch sizes, keyed by EXACT coalesced size
        #: (the bucket it padded into is ``batch_bucket(size)``)
        self.batch_size_hist: Dict[int, int] = {}

    @property
    def mean_batch_size(self) -> float:
        n = sum(self.batch_size_hist.values())
        tot = sum(b * c for b, c in self.batch_size_hist.items())
        return tot / max(n, 1)

    def as_dict(self) -> Dict[str, object]:
        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "n_cached": self.n_cached,
            "n_shed": self.n_shed,
            "mean_batch_size": self.mean_batch_size,
            "batch_size_hist": {str(kk): v for kk, v
                                in sorted(self.batch_size_hist.items())},
        }


class AsyncTopKServer:
    """Micro-batching front end over :class:`TopKServer` (see the module
    docstring), on ``device`` (``None`` = ``cuda``).

    Use as a context manager or call :meth:`close`: two daemon threads
    (dispatcher, harvester) run between :meth:`start` and then.

    ``method="auto"`` (the default) is the measured-cost router; any
    explicit registry name pins the engine as on the synchronous server.
    ``flush_ms`` bounds coalescing delay; ``pipeline_depth`` bounds
    in-flight micro-batches (2 = double buffering). ``n_shards > 0``
    fronts the pipeline with the LSM ladder; ``cost_table`` takes a
    pre-measured :class:`CostTable`.
    """

    def __init__(self, model: SepLRModel, max_batch: int = 64,
                 flush_ms: float = DEFAULT_FLUSH_MS,
                 pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
                 cache_capacity: int = DEFAULT_CACHE_CAPACITY,
                 method: str = "auto",
                 block_size: int = 256, delta_capacity: int = 256,
                 compact_async: bool = False,
                 policy: Optional[AdmissionPolicy] = None,
                 n_shards: int = 0, l1_capacity: Optional[int] = None,
                 cost_table=None, device=None):
        self.server = TopKServer(model, max_batch=max_batch,
                                 block_size=block_size,
                                 delta_capacity=delta_capacity,
                                 compact_async=compact_async,
                                 policy=policy, n_shards=n_shards,
                                 l1_capacity=l1_capacity,
                                 cost_table=cost_table, device=device)
        self.device = self.server.device
        self.max_batch = batch_bucket(max(int(max_batch), 1))
        self.flush_ms = float(flush_ms)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.method = method
        get_engine(method)                    # fail fast on unknown names
        self.cache = ResultCache(cache_capacity)
        self.server.catalogue.add_invalidation_listener(
            self.cache.invalidate)
        self.pipeline_stats = PipelineStats()
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._harvest: "queue.Queue" = queue.Queue(
            maxsize=self.pipeline_depth)
        self._inflight_batches = 0
        self._stop = False
        self._dispatcher: Optional[threading.Thread] = None
        self._harvester: Optional[threading.Thread] = None
        self._thread_errors: List[BaseException] = []
        # the harvester copies results to the host on a stream of its own:
        # on the current stream a copy would wait for every batch
        # dispatched since
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # -- delegation ----------------------------------------------------------

    @property
    def catalogue(self):
        return self.server.catalogue

    @property
    def ctx(self):
        return self.server.ctx

    @property
    def stats(self) -> Dict[str, ServeStats]:
        return self.server.stats

    @property
    def cost_table(self):
        return self.server.cost_table

    @property
    def trace_counts(self) -> Dict[str, int]:
        return self.server.trace_counts

    @property
    def mutation_stats(self) -> Dict[str, float]:
        return self.server.mutation_stats

    def add_targets(self, rows) -> np.ndarray:
        return self.server.add_targets(rows)

    def delete_targets(self, gids) -> None:
        self.server.delete_targets(gids)

    def update_targets(self, gids, rows) -> None:
        self.server.update_targets(gids, rows)

    def warmup(self, k: int, batch_sizes=None, engines=None,
               budgets=None) -> "AsyncTopKServer":
        """Warm EVERY power-of-two bucket up to ``max_batch`` (plus any
        explicit ``batch_sizes``): queue-formed micro-batches land in
        whatever bucket the traffic produced, and each warmed (engine,
        bucket, sign) config gets one timed run into the shared cost
        table, which arms the measured-cost router.

        ``engines=None`` warms the engines this pipeline can DISPATCH:
        ``auto_candidates(device)``, the pinned ``method`` and the
        ladder's ``norm`` fallback."""
        sizes = {1 << i for i in range(self.max_batch.bit_length())
                 if (1 << i) <= self.max_batch}
        sizes.add(self.max_batch)
        if batch_sizes:
            sizes.update(batch_bucket(int(b)) for b in batch_sizes)
        if engines is None:
            engines = sorted({*auto_candidates(self.device), "norm"}
                             | ({self.method} - {"auto"}))
        self.server.warmup(k, batch_sizes=tuple(sorted(sizes)),
                           engines=engines, budgets=budgets)
        return self

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AsyncTopKServer":
        if self._dispatcher is not None:
            return self
        self._stop = False
        self._thread_errors = []
        self._dispatcher = threading.Thread(
            target=self._guarded, args=(self._dispatch_loop,),
            name="topk-dispatch", daemon=True)
        self._harvester = threading.Thread(
            target=self._guarded, args=(self._harvest_loop,),
            name="topk-harvest", daemon=True)
        self._dispatcher.start()
        self._harvester.start()
        return self

    def _guarded(self, loop) -> None:
        """Thread target: an exception that ends a stage thread is kept
        for :meth:`close` to re-raise, and fails every queued request."""
        try:
            loop()
        except BaseException as exc:
            self._thread_errors.append(exc)
            with self._cond:
                self._stop = True
                pending, self._queue = list(self._queue), \
                    collections.deque()
                self._cond.notify_all()
            for r in pending:
                r.fail(exc)
            raise

    def close(self) -> None:
        """Drain and stop both pipeline threads (idempotent). Raises
        ``TimeoutError`` when a thread outlives ``CLOSE_TIMEOUT_S``, and
        re-raises the exception that ended a thread."""
        if self._dispatcher is None:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._dispatcher.join(CLOSE_TIMEOUT_S)
        if not self._dispatcher.is_alive():
            try:
                self._harvest.put(None, timeout=CLOSE_TIMEOUT_S)
            except queue.Full:
                pass                          # a hung harvester: below
            self._harvester.join(CLOSE_TIMEOUT_S)
        hung = [t.name for t in (self._dispatcher, self._harvester)
                if t.is_alive()]
        if hung:
            raise TimeoutError(f"pipeline threads {hung} did not stop "
                               f"within {CLOSE_TIMEOUT_S} s")
        self._dispatcher = None
        self._harvester = None
        if self._thread_errors:
            raise self._thread_errors[0]

    def __enter__(self) -> "AsyncTopKServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ----------------------------------------------------------

    def submit(self, u, k: int, method: Optional[str] = None,
               budget: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> PendingResult:
        """Enqueue ONE query ``u`` ([R]); returns immediately with a
        :class:`PendingResult`. Validation failures raise here, in the
        caller's thread, not on the pipeline."""
        if self._dispatcher is None or self._stop:
            raise RuntimeError("AsyncTopKServer not started or closed "
                               "(use `with server:` or .start())")
        if int(k) <= 0:
            raise ValueError(f"k must be a positive int, got {k!r}")
        if budget is not None and int(budget) <= 0:
            raise ValueError(
                f"budget must be a positive int or None, got {budget!r}")
        if deadline_ms is not None and float(deadline_ms) < 0:
            raise ValueError(
                f"deadline_ms must be >= 0 or None, got {deadline_ms!r}")
        row = np.ascontiguousarray(np.asarray(u, np.float32)).reshape(-1)
        rank = self.catalogue.rank
        if row.shape[0] != rank:
            raise ValueError(
                f"query rank {row.shape[0]} != catalogue rank {rank}")
        if not np.all(np.isfinite(row)):
            raise ValueError("query contains NaN/Inf values")
        m = method if method is not None else self.method
        get_engine(m)
        if deadline_ms is None:
            deadline_ms = self.server.policy.deadline_ms
        req = _Request(row, int(k), m, budget, deadline_ms, self.flush_ms)
        # sampled full-span tracing (cheap counters stay always-on);
        # start is the enqueue timestamp so queue wait is span 1
        req.trace = obs.TRACER.start_trace(
            "topk.request", start=req.t_enqueue, k=int(k), method=m,
            budget=budget if budget is None else int(budget))
        with self._cond:
            self._queue.append(req)
            self.pipeline_stats.n_requests += 1
            self._cond.notify_all()
        return PendingResult(req)

    def query(self, U, k: int, method: Optional[str] = None,
              budget: Optional[int] = None,
              deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None) -> TopKResult:
        """Synchronous convenience: submit every row of ``U`` as an
        independent request and block (each for at most ``timeout``
        seconds) for the batched host result. Rows may coalesce with each
        other AND with concurrent submitters."""
        U2 = np.atleast_2d(np.asarray(U, np.float32))
        handles = [self.submit(U2[i], k, method=method, budget=budget,
                               deadline_ms=deadline_ms)
                   for i in range(U2.shape[0])]
        outs = [h.result(timeout) for h in handles]
        return TopKResult(*(np.concatenate(xs, axis=0)
                            for xs in zip(*outs)))

    # -- stage 1: the dispatcher (host side) ---------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._flushable_locked():
                    self._cond.wait(self._wait_s_locked())
                if self._stop and not self._queue:
                    return
                batch = self._form_batch_locked()
            if batch:
                try:
                    self._dispatch_batch(batch)
                except Exception as exc:      # relayed to the futures
                    for r in batch:
                        r.fail(exc)

    def _flushable_locked(self) -> bool:
        """Head-of-queue flush test (lock held): fire when the pipeline
        is IDLE (coalescing would trade latency for nothing), when a
        full bucket is waiting, or when the oldest request's flush
        deadline has passed."""
        if not self._queue:
            return False
        if self._inflight_batches == 0:
            return True
        if len(self._queue) >= self.max_batch:
            return True
        return time.perf_counter() >= self._queue[0].flush_by

    def _wait_s_locked(self) -> Optional[float]:
        if not self._queue:
            return None
        return max(self._queue[0].flush_by - time.perf_counter(), 0.0)

    def _form_batch_locked(self) -> List[_Request]:
        """Pop the head request plus every queued COMPATIBLE request —
        same (k, method, budget), the static axes of one engine dispatch
        — preserving arrival order, up to ``max_batch``."""
        if not self._queue:
            return []
        head = self._queue[0]
        sig = (head.k, head.method, head.budget)
        batch, keep = [], collections.deque()
        while self._queue:
            r = self._queue.popleft()
            if len(batch) < self.max_batch \
                    and (r.k, r.method, r.budget) == sig:
                batch.append(r)
            else:
                keep.append(r)
        self._queue = keep
        return batch

    def _dispatch_batch(self, batch: List[_Request]) -> None:
        """Host stage for one micro-batch: cache probe, admission ladder,
        batch assembly, sign-bucketing — then the device work, an event
        recorded after it, and the batch handed to the harvester WITHOUT
        waiting on the device."""
        srv = self.server
        t_pop = time.perf_counter()
        k, method = batch[0].k, batch[0].method
        budget = batch[0].budget
        req_name = get_engine(method).name
        # the token is captured BEFORE the scan dispatches: a mutation
        # landing mid-scan bumps the live token, so whatever this scan
        # returns is inserted under a token no future lookup can match
        token = self.catalogue.cache_token()
        misses: List[_Request] = []
        for r in batch:
            obs.on_queue_wait(1e6 * (t_pop - r.t_enqueue))
            row = (None if budget is not None
                   else self.cache.lookup((r.u.tobytes(), r.k, token)))
            if row is not None:
                self.pipeline_stats.n_cached += 1
                if r.trace is not None:
                    r.trace.span("queue_wait", start=r.t_enqueue,
                                 end=t_pop)
                    r.trace.span("cache_hit", start=t_pop,
                                 version=token[0], epoch=token[1])
                self._finish_request(r, method, row)
            else:
                misses.append(r)
        if not misses:
            return
        n = len(misses)
        obs.on_batch_formed(n)
        U = np.stack([r.u for r in misses])
        t_asm = time.perf_counter()
        req_stats = srv.stats.setdefault(req_name, ServeStats())
        eng = (select_engine(self.ctx, U) if method == "auto"
               else get_engine(method))
        # admission at dispatch time, per micro-batch: judged against the
        # TIGHTEST deadline riding in the batch
        deadlines = [r.deadline_s for r in misses
                     if r.deadline_s is not None]
        remaining = (min(deadlines) - time.perf_counter()
                     if deadlines else None)
        run_eng, bud, rung = srv._admit(eng, n, remaining)
        t_route = time.perf_counter()
        if rung != "full":
            req_stats.bump_degradation(rung)
            obs.on_degradation(req_name, rung)
        if run_eng is None:
            res = srv._shed_result(n, k)
            req_stats.note_uncertified(n)
            obs.on_uncertified(req_name, n)
            self.pipeline_stats.n_shed += n
            for r in misses:
                if r.trace is not None:
                    r.trace.span("queue_wait", start=r.t_enqueue,
                                 end=t_pop)
                    r.trace.span("route", start=t_asm, end=t_route,
                                 rung=rung)
            self._fulfill(misses, method, res, cache_token=None)
            self._count_batch(n)
            return
        if bud is None:
            bud = budget
        bcfg = (run_eng.batch_config(self.ctx, U)
                if run_eng.batch_config is not None else ())
        label = (sign_bucket_label(bcfg)
                 if run_eng.batch_config is not None else "")
        # span annotations, assembled once per batch and only when a
        # rider is traced: the cost-table entry the router consulted and
        # the stage timestamps the harvester turns into child spans
        tinfo = None
        if any(r.trace is not None for r in misses):
            bucket = batch_bucket(n)
            key = run_eng.name if bud is None else f"{run_eng.name}@budget"
            pred = srv.cost_table.predict(key, bucket, label)
            tinfo = {
                "t_pop": t_pop, "t_asm": t_asm, "t_route": t_route,
                "engine": run_eng.name, "rung": rung,
                "cost_entry": f"{key}|{bucket}|{label}",
                "predicted_us": (None if pred is None else 1e6 * pred),
                "sign": label, "batch_size": n,
                "version": token[0], "epoch": token[1],
            }
        t0 = time.perf_counter()
        res, info = self.catalogue.query(run_eng, U, k, budget=bud,
                                         bcfg=bcfg)
        done = None
        if self._copy_stream is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        # no host copy here: blocking is the harvester's job. The put
        # back-pressures the dispatcher once `pipeline_depth`
        # micro-batches are unharvested.
        with self._cond:
            self._inflight_batches += 1
        try:
            self._hand_over((misses, method, run_eng, bud, rung, label,
                             res, info, t0, token, tinfo, done))
        except Exception:
            with self._cond:
                self._inflight_batches -= 1
            raise
        self._count_batch(n)

    def _hand_over(self, item) -> None:
        """Put a dispatched batch on the harvest queue, waiting while it is
        full; raise if the harvester thread has died meanwhile."""
        while True:
            try:
                self._harvest.put(item, timeout=0.1)
                return
            except queue.Full:
                if not self._harvester.is_alive():
                    raise RuntimeError("the harvester thread has stopped")

    def _count_batch(self, n: int) -> None:
        self.pipeline_stats.n_batches += 1
        self.pipeline_stats.batch_size_hist[n] = \
            self.pipeline_stats.batch_size_hist.get(n, 0) + 1

    # -- stage 2: the harvester (device sync side) ---------------------------

    def _harvest_loop(self) -> None:
        while True:
            item = self._harvest.get()
            if item is None:
                return
            (misses, method, run_eng, bud, rung, label,
             res, info, t0, token, tinfo, done) = item
            try:
                if done is None:
                    res = _to_host(res)
                else:
                    done.synchronize()        # the only wait on the device
                    with torch.cuda.stream(self._copy_stream):
                        res = _to_host(res)
                t_harvested = time.perf_counter()
                self._harvest_batch(misses, method, run_eng, bud, label,
                                    res, info, t0, token, tinfo,
                                    t_harvested)
            except Exception as exc:          # relayed to the futures
                for r in misses:
                    r.fail(exc)
            finally:
                with self._cond:
                    self._inflight_batches -= 1
                    self._cond.notify_all()

    def _harvest_batch(self, misses, method, run_eng, bud, label, res,
                       info, t0, token, tinfo, t_harvested) -> None:
        """Stats, cost model, spans and the futures of one batch whose
        result is on the host."""
        dt = t_harvested - t0
        n = len(misses)
        if res.upper is None:
            res = res._replace(upper=np.full(
                (res.values.shape[0],), -np.inf, np.float32))
        req_stats = self.stats.setdefault(get_engine(method).name,
                                          ServeStats())
        if bud is not None:
            self.server._note_certificates(req_stats, run_eng.name, bud,
                                           res)
        key = run_eng.name if bud is None else f"{run_eng.name}@budget"
        per_q = dt / max(n, 1)
        prev = self.server._cost_ewma.get(key)
        self.server._cost_ewma[key] = (
            per_q if prev is None else 0.8 * prev + 0.2 * per_q)
        self.cost_table.observe(key, batch_bucket(n), label, per_q)
        self.server._record(run_eng.name, res, dt, n, info.delta_scored,
                            sign_label=label)
        if tinfo is not None:
            t_done = time.perf_counter()
            for r in misses:
                if r.trace is None:
                    continue
                r.trace.root.set(engine=tinfo["engine"],
                                 version=tinfo["version"],
                                 epoch=tinfo["epoch"])
                r.trace.span("queue_wait", start=r.t_enqueue,
                             end=tinfo["t_pop"])
                r.trace.span("coalesce", start=tinfo["t_pop"],
                             end=tinfo["t_asm"],
                             batch_size=tinfo["batch_size"])
                r.trace.span("route", start=tinfo["t_asm"],
                             end=tinfo["t_route"], engine=tinfo["engine"],
                             rung=tinfo["rung"],
                             cost_entry=tinfo["cost_entry"],
                             predicted_us=tinfo["predicted_us"])
                r.trace.span("dispatch", start=tinfo["t_route"], end=t0)
                r.trace.span("device", start=t0, end=t_harvested,
                             engine=tinfo["engine"], sign=tinfo["sign"],
                             version=tinfo["version"],
                             epoch=tinfo["epoch"])
                r.trace.span("harvest", start=t_harvested, end=t_done)
        # only the EXACT path populates the cache (bud is the effective
        # budget: a ladder downgrade never caches)
        self._fulfill(misses, method, res,
                      cache_token=None if bud is not None else token)

    def _fulfill(self, batch: List[_Request], method: str,
                 res: TopKResult, cache_token: Optional[tuple]) -> None:
        """Unpad a batched host result into per-request rows, fulfil the
        futures, and (exact results only) populate the cache."""
        vals, ids, nsc, depth = (np.asarray(x) for x in res[:4])
        upper = (np.full((vals.shape[0],), -np.inf, np.float32)
                 if res.upper is None else np.asarray(res.upper))
        t_merge = time.perf_counter()
        for i, r in enumerate(batch):
            row = (vals[i], ids[i], nsc[i], depth[i], upper[i])
            if cache_token is not None:
                self.cache.insert((r.u.tobytes(), r.k, cache_token), row)
            if r.trace is not None:
                r.trace.span("merge", start=t_merge)
            self._finish_request(r, method, row)

    def _finish_request(self, r: _Request, method: str,
                        row: tuple) -> None:
        name = get_engine(method).name
        stats = self.stats.setdefault(name, ServeStats())
        us = 1e6 * (time.perf_counter() - r.t_enqueue)
        stats.record_request_latency(us)
        obs.on_request_done(name, us)
        if r.trace is not None:
            r.trace.finish()
            # drop the request's reference: finished traces live only in
            # the tracer's bounded store
            r.trace = None
        r.fulfill(row)
