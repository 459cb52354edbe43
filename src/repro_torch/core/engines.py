"""Engine registry: every top-K engine behind one name-keyed interface.

The serving layer, the CLI and the tests dispatch through this registry
instead of hand-rolled ``if/elif`` chains. An :class:`Engine` bundles its
batched body with capability metadata (exact? needs the index? budget?
which backend? which layout?), so callers can enumerate and sweep engines.

Engines run against an :class:`EngineContext`: the catalogue on a device
plus lazily built derived state (sorted-list index, layouts, the kernel
catalogue, per-engine arguments) shared across queries.

Registered engines:

================  =====  ===========  ========  ============  ====================
name              exact  needs_index  backend   layout        algorithm
================  =====  ===========  ========  ============  ====================
``naive``         yes    no           torch     row_major     full matmul + top-k
``ta``            yes    yes          torch     list_major    Threshold Algorithm
                                                              (paper Alg. 2),
                                                              chunked; tail scored
                                                              by kernel B4
``bta``           yes    yes          torch     list_major    Block Threshold
                                                              Algorithm; tail
                                                              scored by kernel B4
``norm``          yes    yes          torch     norm_major    Cauchy-Schwarz scan
``norm_sharded``  yes    yes          torch     norm_sharded  the norm scan per
                                                              shard of a mesh,
                                                              cross-shard
                                                              tightening
``topk_mips``     yes    yes          cuda      norm_major    the scan as a CUDA
                                                              kernel (two-level
                                                              pre-screen)
``fagin``         yes    yes          numpy     row_major     Fagin's Algorithm
                                                              (paper Alg. 1; host
                                                              oracle)
``partial``       yes    yes          numpy     row_major     Partial TA (paper
                                                              Alg. 3; host oracle)
``auto``          yes    yes          dispatch  —             picks per batch
================  =====  ===========  ========  ============  ====================

The two ``numpy`` rows are the paper's host oracles: item at a time,
``host_only``, one query after another (``supports_batch=False``); they
run as dispatch loops over the catalogue read to the host. ``auto``
picks an engine per batch (:func:`select_engine`): from the measured
:class:`CostTable` when it holds every candidate at the batch's (bucket,
sign), else from host statistics — sparse batches to ``ta``, dense ones
over a decaying norm spectrum to the norm scan (``topk_mips`` for a
context on the card, ``norm`` on the CPU), flat-spectrum dense batches
to ``bta``. The oracles and ``auto`` have no ``run_args``
(:attr:`Engine.has_executable` is False), so warmups skip them.

Every executable engine takes a batch. Aliases accepted by
:func:`get_engine`: ``threshold -> ta``, ``blocked -> bta``,
``norm_pruned -> norm`` and ``pallas -> topk_mips`` (the reference's
name for its kernel engine).

PyTorch runs eagerly and the kernels take their sizes at run time, so
there is no compile cache to key. Batches are still bucketed to powers of
two (:func:`pad_to_bucket`) and the ``norm`` engine still pads its arrays
to the catalogue's M-bucket, exactly as the reference, so results and
pruning statistics match it field for field. ``bta`` and ``ta`` run on
the real M: the reference pads its list arrays only so that one compiled
executable serves every catalogue of a bucket, and its padded results
equal the unpadded scan's. ``topk_mips.launches`` and
``gather_scores.launches`` count the CUDA kernels' launches, and
:attr:`EngineContext.scan_steps` counts the list scans' loop iterations.
In place of the reference's trace counters, the port counts kernel
library loads (:func:`repro_torch.kernels._build.loads_total`, its
compile counter): :attr:`EngineContext.trace_counts` attributes each
engine run's delta of it to the engine, as the reference attributes its
traces.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core.blocked import (blocked_topk_batched,
                                      blocked_topk_batched_native,
                                      chunked_ta_topk_batched,
                                      chunked_ta_topk_batched_native,
                                      norm_pruned_topk_batched)
from repro_torch.core.driver import NEG_INF, pad_topk
from repro_torch.core.fagin import fagin_topk_np
from repro_torch.core.index import TopKIndex, build_index, to_host
from repro_torch.core.layout import (DEFAULT_PREFIX_DEPTH,
                                     LIST_LAYOUT_MIN_TARGETS, build_layout,
                                     pad_zero_rows)
from repro_torch.core.naive import TopKResult, naive_topk
from repro_torch.core.partial import partial_threshold_topk_np
from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.core.sharded import sharded_norm_topk
from repro_torch.core.strategies import sign_bucket, sign_bucket_label


def batch_bucket(n: int) -> int:
    """Next power of two >= n — the batch granularity."""
    return 1 << max(0, int(n) - 1).bit_length()


def m_bucket(m: int) -> int:
    """Next power of two >= m — the catalogue granularity of padded
    engine arguments (pad rows zero, norm 0, id -1)."""
    return batch_bucket(m)


def pad_to_bucket(U: torch.Tensor) -> torch.Tensor:
    """Pad a ``[B, R]`` batch to its power-of-two bucket by repeating the
    LAST query row — never zeros (an all-zero query deactivates every
    list of the list engines)."""
    b = U.shape[0]
    bucket = batch_bucket(b)
    if bucket == b:
        return U
    return torch.cat([U, U[b - 1:b].expand(bucket - b, U.shape[1])], dim=0)


def note_pruning_metrics(engine: str, n: int, n_scored: int,
                         depth_sum: int, m_live: int,
                         per_query_us: float,
                         sign_label: str = "") -> None:
    """Record one served batch's pruning-efficiency metrics into the
    observability registry: ``n_scored`` and ``depth`` totals plus the
    scored FRACTION of the live catalogue (DESIGN.md §14). The serving
    layer calls it after the result reached the host."""
    obs.on_batch_served(engine, n, n_scored, depth_sum, m_live,
                        per_query_us, sign_label)


def _loads_total() -> int:
    # imported here: the kernels package imports from core
    from repro_torch.kernels._build import loads_total
    return loads_total()


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CostTable:
    """Measured per-(engine, batch-bucket, label) serve cost.

    An EWMA (default ``alpha=0.2``) of observed per-QUERY seconds, keyed
    by engine name, power-of-two batch bucket and sign-bucket label
    (:func:`cost_label` at warm time, empty for engines without batch
    specialisation; the server records ``sign_bucket_label``). Budgeted
    runs record under ``"<engine>@budget"``. :meth:`predict` is the
    router's granular view, falling back label -> ``""`` -> engine
    aggregate unless ``granular_only=True``; :meth:`engine_cost` is the
    admission ladder's shape-agnostic one. Thread-safe.
    :meth:`EngineContext.warmup` primes it with one timed run per warmed
    (engine, bucket, sign, budget).
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma: Dict[Tuple[str, int, str], float] = {}
        self._engine: Dict[str, float] = {}
        self.n_observations = 0

    def observe(self, engine: str, bucket: int, label: str,
                per_query_s: float) -> None:
        """Fold one measured per-query latency into the table."""
        key = (engine, int(bucket), label)
        a = self.alpha
        with self._lock:
            prev = self._ewma.get(key)
            ewma = (per_query_s if prev is None
                    else (1 - a) * prev + a * per_query_s)
            self._ewma[key] = ewma
            prev_e = self._engine.get(engine)
            self._engine[engine] = (per_query_s if prev_e is None
                                    else (1 - a) * prev_e + a * per_query_s)
            self.n_observations += 1
        # the folded EWMA (the router's current belief), exported live
        obs.on_cost_observation(engine, bucket, label, ewma)

    def predict(self, engine: str, bucket: int, label: str,
                granular_only: bool = False) -> Optional[float]:
        """Predicted per-query seconds, or None when nothing relevant was
        measured. Falls back (engine, bucket, label) -> (engine, bucket,
        "") -> engine aggregate unless granular_only."""
        with self._lock:
            c = self._ewma.get((engine, int(bucket), label))
            if c is None:
                c = self._ewma.get((engine, int(bucket), ""))
            if c is None and not granular_only:
                c = self._engine.get(engine)
            return c

    def engine_cost(self, engine: str) -> Optional[float]:
        """Shape-agnostic per-query seconds for ``engine`` (EWMA over
        every observation), or None if never measured."""
        with self._lock:
            return self._engine.get(engine)

    def snapshot(self) -> Dict[str, float]:
        """``"engine|bucket|label" -> seconds`` view for artifacts."""
        with self._lock:
            return {f"{e}|{b}|{lbl}": v
                    for (e, b, lbl), v in sorted(self._ewma.items())}

    def save(self, path) -> None:
        """Persist the table as JSON (entries as ``[engine, bucket,
        label, seconds]`` lists), in the reference's format."""
        with self._lock:
            payload = {
                "alpha": self.alpha,
                "n_observations": self.n_observations,
                "ewma": [[e, int(b), lbl, float(v)]
                         for (e, b, lbl), v in sorted(self._ewma.items())],
                "engine": {e: float(v)
                           for e, v in sorted(self._engine.items())},
            }
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path) -> "CostTable":
        """Reconstruct a table saved by :meth:`save`."""
        with open(path) as fh:
            payload = json.load(fh)
        table = cls(alpha=float(payload.get("alpha", 0.2)))
        with table._lock:
            for e, b, lbl, v in payload.get("ewma", []):
                table._ewma[(str(e), int(b), str(lbl))] = float(v)
            table._engine = {str(e): float(v)
                             for e, v in payload.get("engine", {}).items()}
            table.n_observations = int(payload.get("n_observations", 0))
        return table


class EngineContext:
    """Catalogue + lazily built per-engine state, shared across queries.

    Args:
      targets: ``[M, R]`` catalogue factors (host array or tensor).
      index: optional prebuilt :class:`TopKIndex` (built lazily otherwise).
      block_size: depth/block granularity handed to blocked engines.
      max_blocks: uniform halting budget in blocks (``-1`` = run to
        exactness); rounds for ``ta``.
      ta_chunk: TA rounds gathered and scored per step by the ``ta``
        engine (its replay keeps the counts of one round a step).
      prefix_depth: ``list_major`` layout prefix rows per dimension.
        ``None`` (default) is ADAPTIVE — the layout turns on at
        ``DEFAULT_PREFIX_DEPTH`` once ``M >= LIST_LAYOUT_MIN_TARGETS``
        and stays off below that; ``0`` disables it; any other value is
        honoured (clamped to ``M``). See :attr:`resolved_prefix_depth`.
      cost_table: measured-cost table shared with the serving layer.
      version: snapshot version of the catalogue (the streaming tier
        builds one context per compacted snapshot).
      device: where the catalogue and every derived array live
        (``None`` = ``cuda``).

    ``scan_steps`` counts the list scans' loop iterations — each one host
    read — by phase (``"prefix"``, ``"tail"``, ``"gather"``).
    ``trace_counts`` counts, per engine, the kernel library loads its runs
    on this context caused (the port's compiles: 0 once the libraries are
    loaded in the process).
    """

    def __init__(self, targets, index: Optional[TopKIndex] = None,
                 block_size: int = 256, max_blocks: int = -1,
                 ta_chunk: int = 32, prefix_depth: Optional[int] = None,
                 cost_table: Optional[CostTable] = None, version: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.version = int(version)
        self.trace_counts: Dict[str, int] = {}
        self.targets = torch.as_tensor(targets, dtype=torch.float32,
                                       device=self.device).contiguous()
        self.cost_table = cost_table
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.ta_chunk = ta_chunk
        self.prefix_depth = prefix_depth
        self.scan_steps: collections.Counter = collections.Counter()
        self._index = index
        self._catalog = None
        self._norm_decay: Optional[float] = None
        self._layouts: Dict[str, object] = {}
        self._engine_args: Dict[str, Any] = {}
        self._mesh = None

    @property
    def num_targets(self) -> int:
        return int(self.targets.shape[0])

    @property
    def rank(self) -> int:
        return int(self.targets.shape[1])

    @property
    def m_bucket(self) -> int:
        """The catalogue's power-of-two M-bucket."""
        return m_bucket(self.num_targets)

    @property
    def resolved_prefix_depth(self) -> int:
        """The list_major prefix depth this context builds (0 = off):
        adaptive when ``prefix_depth`` is None (on only from
        ``LIST_LAYOUT_MIN_TARGETS`` rows), else as given, clamped to M."""
        if self.prefix_depth is None:
            if self.num_targets < LIST_LAYOUT_MIN_TARGETS:
                return 0
            return int(min(self.num_targets, DEFAULT_PREFIX_DEPTH))
        return int(min(self.num_targets, self.prefix_depth))

    @property
    def index(self) -> TopKIndex:
        if self._index is None:
            self._index = build_index(self.targets, device=self.device)
        return self._index

    @property
    def catalog(self):
        """Norm-ordered kernel catalogue (built on first kernel query)."""
        if self._catalog is None:
            # imported here: kernels.ops imports from core, whose package
            # imports this module
            from repro_torch.kernels.ops import MIPSCatalog
            self._catalog = MIPSCatalog(self.targets, block_m=self.block_size,
                                        device=self.device)
        return self._catalog

    @property
    def norm_decay(self) -> float:
        """Norm at the 10th-percentile depth over the head norm (<= 1).

        A catalogue constant, read to the host once and cached, so the
        per-batch ``auto`` dispatch reads no norms from the card.
        """
        if self._norm_decay is None:
            norms = to_host(self.index.norms_sorted)
            head = max(float(norms[0]), 1e-12)
            decayed = float(
                norms[min(len(norms) - 1, max(1, len(norms) // 10))])
            self._norm_decay = decayed / head
        return self._norm_decay

    def layout(self, name: str):
        """The named catalogue layout, built lazily and cached.

        ``norm_sharded`` deals the norm order over :attr:`mesh`'s devices
        (a 1-device mesh is valid: the sharded scan then degenerates to
        the single-host one), with slabs sized for the M-bucket.
        """
        lay = self._layouts.get(name)
        if lay is None:
            params = {"device": self.device}
            if name == "list_major":
                params["prefix_depth"] = self.resolved_prefix_depth
            elif name == "norm_sharded":
                params.update(n_shards=self.mesh.size, mesh=self.mesh,
                              m_total=self.m_bucket)
            index = None if name == "row_major" else self.index
            lay = build_layout(name, self.targets, index, **params)
            self._layouts[name] = lay
        return lay

    @property
    def mesh(self) -> Mesh:
        """1-axis ``("data",)`` mesh over every visible device of the
        context's device type (every CUDA device for a context on the
        card, one ``cpu`` otherwise), built lazily. Replace ``_mesh``
        before the first ``layout("norm_sharded")`` to shard otherwise
        (``make_mesh((4,), ("data",), ["cpu"] * 4)``)."""
        if self._mesh is None:
            devs = ([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
                    if self.device.type == "cuda" else [self.device])
            self._mesh = make_mesh((len(devs),), ("data",), devs)
        return self._mesh

    @property
    def prepared_engines(self) -> List[str]:
        """Engines whose arguments this context has built."""
        return list(self._engine_args)

    def engine_args(self, engine: "Engine"):
        """``engine``'s prepared arguments at the catalogue's M-bucket,
        built once per context."""
        args = self._engine_args.get(engine.name)
        if args is None:
            args = engine.make_args(self, self.m_bucket)
            self._engine_args[engine.name] = args
        return args

    def run_engine(self, engine: "Engine", U, k: int,
                   budget: Optional[int] = None,
                   bcfg: Optional[tuple] = None) -> TopKResult:
        """Bucket the batch, pad, run the engine, slice back.

        Padding repeats the LAST query row; padded rows are dropped before
        returning, so per-query statistics are untouched. ``bcfg`` is the
        batch's ``engine.batch_config``, worked out here when the caller
        has not already done so.
        """
        U = torch.atleast_2d(torch.as_tensor(U, dtype=torch.float32,
                                             device=self.device))
        if bcfg is None:
            bcfg = (engine.batch_config(self, U)
                    if engine.batch_config is not None else ())
        b = U.shape[0]
        U = pad_to_bucket(U).contiguous()
        before = _loads_total()
        res = engine.run_args(self, self.engine_args(engine), U, int(k),
                              budget, bcfg)
        delta = _loads_total() - before
        if delta:
            self.trace_counts[engine.name] = (
                self.trace_counts.get(engine.name, 0) + delta)
        if U.shape[0] != b:
            # an engine without a certificate bound returns upper=None
            res = TopKResult(*(None if x is None else x[:b] for x in res))
        return res

    def warmup(self, k: int, batch_sizes=(1, 8, 64),
               engines: Optional[List[str]] = None, budgets=None,
               cost_table: Optional[CostTable] = None) -> "EngineContext":
        """Build every engine's lazy state (index, layouts, kernel
        catalogue, the CUDA library) ahead of traffic, and prime
        ``cost_table`` (default: the context's own).

        ``engines`` defaults to every engine with an executable body
        (:attr:`Engine.has_executable`: not ``auto``, not the host
        oracles). Each is run on one representative batch per bucket —
        one per sign bucket for the engines that specialise on it
        (:meth:`_warm_batches`) — and, for budget-capable engines, once
        more per entry of ``budgets`` (halting budgets in rows). Each such
        run is followed by one timed run recorded in the table under
        :func:`cost_label`, budgeted ones under ``"<name>@budget"``
        (:meth:`_time_into`). Returns self for chaining."""
        names = list(engines) if engines is not None else [
            e.name for e in list_engines() if e.has_executable]
        budget_list = [None] + [int(x) for x in (budgets or ())]
        ct = cost_table if cost_table is not None else self.cost_table
        for name in names:
            eng = get_engine(name)
            if not eng.has_executable:
                raise ValueError(
                    f"engine {eng.name!r} is dispatch-only and has no "
                    "executable to warm")
            buds = budget_list if eng.supports_budget else [None]
            for b in batch_sizes:
                bucket = batch_bucket(b)
                for U in self._warm_batches(eng, bucket):
                    for bud in buds:
                        eng.run(self, U, k, budget=bud)
                        synchronize(self.device)
                        if ct is not None:
                            self._time_into(ct, eng, U, k, bud, bucket)
        return self

    def _time_into(self, ct: CostTable, eng: "Engine", U: torch.Tensor,
                   k: int, bud: Optional[int], bucket: int) -> None:
        """One timed run, folded into the cost table under the (engine,
        bucket, sign-label) key the router reads — budgeted runs under the
        ladder's ``"<name>@budget"`` name."""
        t0 = time.perf_counter()
        eng.run(self, U, k, budget=bud)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        name = eng.name if bud is None else f"{eng.name}@budget"
        ct.observe(name, bucket, cost_label(eng, self, U), dt / bucket)

    def _warm_batches(self, eng: "Engine", bucket: int) -> list:
        """Representative warm batches: one per common sign bucket —
        non-negative dense (ones), non-positive dense, mixed (alternating
        +-1) and non-negative sparse (alternating 1/0) — for an engine
        that specialises on it, else the all-ones batch alone."""
        ones = torch.ones((bucket, self.rank), dtype=torch.float32,
                          device=self.device)
        if eng.batch_config is None or not eng.batch_config(self, ones):
            return [ones]
        mixed = ones.clone()
        mixed[:, 1::2] = -1.0
        sparse = ones.clone()
        sparse[:, 1::2] = 0.0
        # buckets: (1, True), (-1, True), (0, False), (1, False)
        return [ones, -ones, mixed, sparse]


@dataclasses.dataclass(frozen=True)
class Engine:
    """A registered engine: batched body + capability metadata.

    One of two execution styles:

    * ``make_args`` + ``run_args`` — an executable engine.
      ``make_args(ctx, m_bucket)`` prepares the engine's arguments from the
      context once (cached by :meth:`EngineContext.engine_args`);
      ``run_args(ctx, args, U, k, budget, bcfg)`` is the batched body over
      a ``[B, R]`` tensor on the context's device. ``batch_config(ctx,
      U)``, where set, is the batch's specialisation (the list engines'
      sign bucket): worked out once per batch and handed to ``run_args``
      as ``bcfg`` (``()`` for engines without one); the server also
      records it per served batch.
    * ``dispatch(ctx, U, k[, budget])`` — the ``auto`` router and the
      host oracles (``fagin``, ``partial``), run per batch as they are.

    ``traffic(ctx, res)`` estimates the engine's memory traffic for a
    measured result (per-query means: rows gathered, contiguous rows
    read, bytes moved).
    """

    name: str
    make_args: Optional[Callable[[EngineContext, int], Any]] = None
    run_args: Optional[Callable[[EngineContext, Any, torch.Tensor, int,
                                 Optional[int], tuple], TopKResult]] = None
    dispatch: Optional[Callable[..., TopKResult]] = None
    exact: bool = True
    needs_index: bool = True
    supports_batch: bool = True
    #: True for engines that honour ``run(..., budget=)`` — a halting
    #: budget in rows (norm-order rows; list depth for ``bta``, rounded
    #: up to whole blocks; rounds for ``ta``), with the halted result
    #: carrying a per-item certificate bound (``TopKResult.upper``)
    supports_budget: bool = False
    backend: str = "torch"
    layout: Optional[str] = None
    batch_config: Optional[Callable[[EngineContext, Any], tuple]] = None
    host_only: bool = False
    traffic: Optional[
        Callable[[EngineContext, TopKResult], Dict[str, float]]] = None
    description: str = ""

    @property
    def has_executable(self) -> bool:
        """True for engines with a batched body (everything but the
        ``auto`` router and the host oracles)."""
        return self.run_args is not None

    def run(self, ctx: EngineContext, U, k: int,
            budget: Optional[int] = None,
            bcfg: Optional[tuple] = None) -> TopKResult:
        if budget is not None and not self.supports_budget:
            raise ValueError(
                f"engine {self.name!r} does not support budgeted queries; "
                "use one of "
                f"{[e.name for e in list_engines() if e.supports_budget]}")
        if self.dispatch is not None:
            if budget is not None:
                return self.dispatch(ctx, U, k, budget)
            return self.dispatch(ctx, U, k)
        return ctx.run_engine(self, U, k, budget=budget, bcfg=bcfg)


_REGISTRY: Dict[str, Engine] = {}
_ALIASES: Dict[str, str] = {
    "threshold": "ta",
    "blocked": "bta",
    "norm_pruned": "norm",
    "pallas": "topk_mips",
}


def register_engine(engine: Engine) -> Engine:
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str) -> Engine:
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def engine_names() -> List[str]:
    return sorted(_REGISTRY)


def list_engines(exact: Optional[bool] = None,
                 backend: Optional[str] = None,
                 needs_index: Optional[bool] = None) -> List[Engine]:
    out = []
    for name in engine_names():
        e = _REGISTRY[name]
        if exact is not None and e.exact != exact:
            continue
        if backend is not None and e.backend != backend:
            continue
        if needs_index is not None and e.needs_index != needs_index:
            continue
        out.append(e)
    return out


# ---------------------------------------------------------------------------
# Built-in engines
# ---------------------------------------------------------------------------


def _naive_args(ctx: EngineContext, bucket: int):
    return {"targets": ctx.targets, "m_bucket": bucket}


def _naive_run(ctx, args, U, k, budget, bcfg):
    # budget ignored: one matmul scores everything
    T = args["targets"]
    m = T.shape[0]
    # the reference pads the catalogue to its M-bucket and masks the pad
    # scores to -inf; scoring only the real rows and filling the slots past
    # M with (-inf, -1) gives the same result without the padded matmul
    kb = min(int(k), args["m_bucket"])
    res = naive_topk(T, U, min(kb, m))
    vals, ids = pad_topk(res.values, res.indices, kb)
    ids = torch.where(torch.isneginf(vals), torch.full_like(ids, -1), ids)
    b = U.shape[0]
    dev = U.device
    # a full scan leaves nothing unenumerated: vacuous -inf bound
    return TopKResult(vals, ids,
                      torch.full((b,), m, dtype=torch.int32, device=dev),
                      torch.zeros((b,), dtype=torch.int32, device=dev),
                      upper=torch.full((b,), NEG_INF, dtype=vals.dtype,
                                       device=dev))


def _norm_args(ctx: EngineContext, bucket: int):
    lay = ctx.layout("norm_major")
    pad = bucket - ctx.num_targets
    # pad rows: zero rows with norm 0 and id -1 — they sort last, so the
    # real norm-order prefix (and every bound the scan can reach) is
    # untouched
    return {
        "targets_by_norm": pad_zero_rows(lay.targets_by_norm, bucket),
        "norm_order": torch.cat([lay.norm_order, torch.full(
            (pad,), -1, dtype=torch.int32, device=ctx.device)]),
        "norms_sorted": pad_zero_rows(lay.norms_sorted, bucket),
        "m_real": ctx.num_targets,
    }


def _budget_blocks(ctx: EngineContext, budget: Optional[int]) -> int:
    """The context's block cap, tightened by a budget in rows (rounded up
    to whole blocks, at least one)."""
    max_blocks = ctx.max_blocks
    if budget is not None:
        bb = max(1, -(-int(budget) // ctx.block_size))
        max_blocks = bb if max_blocks < 0 else min(max_blocks, bb)
    return max_blocks


def _list_layout(ctx: EngineContext):
    """The list_major layout, or None when the context disables it."""
    return ctx.layout("list_major") if ctx.resolved_prefix_depth > 0 \
        else None


def _list_batch_cfg(ctx: EngineContext, U) -> tuple:
    """Sign bucket of the query batch; ``()`` with the list layout off
    (the gather path serves every batch alike)."""
    if ctx.resolved_prefix_depth <= 0:
        return ()
    return sign_bucket(U)


def _list_args(ctx: EngineContext, bucket: int):
    """The list engines' arguments: the catalogue, the sorted-list index
    and the list layout, all at the real M (``bucket`` only sizes the
    result's slots, as for ``naive``)."""
    return {"targets": ctx.targets, "index": ctx.index,
            "layout": _list_layout(ctx), "m_bucket": bucket}


def _pad_past_m(res: TopKResult, args, k: int) -> TopKResult:
    """k past M: the slots beyond the catalogue hold (-inf, -1), as
    naive's."""
    vals, ids = pad_topk(res.values, res.indices,
                         min(int(k), args["m_bucket"]))
    return res._replace(values=vals, indices=ids)


def _ta_run(ctx, args, U, k, budget, bcfg):
    # chunked TA: block-shaped steps, sequential-round accounting. TA's
    # round unit is list depth, so a budget caps rounds directly
    chunk = ctx.ta_chunk
    max_rounds = ctx.max_blocks
    if budget is not None:
        max_rounds = (int(budget) if max_rounds < 0
                      else min(max_rounds, int(budget)))
    T, idx, lay = args["targets"], args["index"], args["layout"]
    kk = min(int(k), T.shape[0])
    if bcfg and lay is not None and lay.serves_sign(bcfg[0]) \
            and lay.prefix_steps(chunk) > 0:
        sign, dense = bcfg
        res = chunked_ta_topk_batched_native(
            T, idx.order_desc, idx.t_sorted_desc, U, kk, chunk=chunk,
            max_rounds=max_rounds, layout=lay, sign=sign, dense=dense,
            steps=ctx.scan_steps)
    else:
        # a single-sided layout cannot serve the other sign buckets, and
        # a prefix shorter than one chunk none: the gather path
        res = chunked_ta_topk_batched(T, idx, U, kk, chunk, max_rounds,
                                      steps=ctx.scan_steps)
    return _pad_past_m(res, args, k)


def _bta_run(ctx, args, U, k, budget, bcfg):
    block_size = ctx.block_size
    # budget is list-depth rows; BTA halts at block granularity
    max_blocks = _budget_blocks(ctx, budget)
    T, idx, lay = args["targets"], args["index"], args["layout"]
    kk = min(int(k), T.shape[0])
    if bcfg and lay is not None and lay.serves_sign(bcfg[0]) \
            and lay.prefix_steps(block_size) > 0:
        sign, dense = bcfg
        res = blocked_topk_batched_native(
            T, idx.order_desc, idx.t_sorted_desc, U, kk,
            block_size=block_size, max_blocks=max_blocks, layout=lay,
            sign=sign, dense=dense, steps=ctx.scan_steps)
    else:
        # a single-sided layout cannot serve the other sign buckets, and
        # a prefix shorter than one block none: the gather path
        res = blocked_topk_batched(T, idx, U, kk, block_size, max_blocks,
                                   steps=ctx.scan_steps)
    return _pad_past_m(res, args, k)


def _norm_run(ctx, args, U, k, budget, bcfg):
    block_size = ctx.block_size
    # budget is rows enumerated in norm order, i.e. blocks * block
    max_blocks = _budget_blocks(ctx, budget)
    mb = args["targets_by_norm"].shape[0]
    # tiny catalogues shrink the block to the bucket so the slice fits
    return norm_pruned_topk_batched(
        args["targets_by_norm"], args["norm_order"], args["norms_sorted"],
        U, k, min(block_size, mb), max_blocks, m_real=args["m_real"])


def _norm_sharded_args(ctx: EngineContext, bucket: int):
    # the context's layout: slabs dealt over ctx.mesh for m_total =
    # ctx.m_bucket, the only bucket engine_args asks for
    lay = ctx.layout("norm_sharded")
    return {"targets_sharded": lay.targets_sharded,
            "norms_sharded": lay.norms_sharded,
            "ids_sharded": lay.ids_sharded}


def _norm_sharded_run(ctx, args, U, k, budget, bcfg):
    # budget unsupported (supports_budget=False): Engine.run refuses one
    scan = sharded_norm_topk(ctx.mesh, ("data",))
    return scan(args["targets_sharded"], args["norms_sharded"],
                args["ids_sharded"], U, k, ctx.block_size, ctx.max_blocks)


def _topk_mips_args(ctx: EngineContext, bucket: int):
    return {"catalog": ctx.catalog}


def _topk_mips_run(ctx, args, U, k, budget, bcfg):
    cat = args["catalog"]
    vals, ids, stats = cat.query_batch(U, k)
    # stats = (rows scored incl. block padding, tiles visited, loaded);
    # an exact kernel: vacuous -inf bound => fully certified result
    return TopKResult(vals, ids, stats[:, 0], stats[:, 1] * cat.block_m,
                      upper=torch.full((U.shape[0],), NEG_INF,
                                       dtype=vals.dtype, device=vals.device))


def _host_array(U) -> np.ndarray:
    """A query batch on the host: numpy and lists as they are, a tensor
    read back once (an input value: nothing is enqueued on the card)."""
    return U if isinstance(U, np.ndarray) else to_host(U)


def _host_nnz_frac(arr: np.ndarray) -> float:
    """Batch sparsity of a host array."""
    return float(np.count_nonzero(arr)) / max(arr.size, 1)


#: COLD-START batch size from which the batched list scan is assumed to
#: amortise its shared tile enumeration well enough to prefer the list
#: engines. Once a :class:`CostTable` has a measurement for every auto
#: candidate at the batch's (bucket, sign), the measured costs replace it.
BATCHED_LIST_MIN_B = 8


def _scan_engine(device) -> str:
    """The norm scan ``auto`` routes to: the kernel engine for a context
    on the card, the ``norm`` engine elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    return "topk_mips" if dev.type == "cuda" else "norm"


def cost_label(eng: Engine, ctx: EngineContext, U) -> str:
    """The sign-bucket label ``eng`` would serve ``U`` under — the third
    axis of every :class:`CostTable` key warmup primes and the router
    reads. Empty for engines without batch specialisation (and for the
    list engines while the layout is off)."""
    if eng.batch_config is None:
        return ""
    bcfg = eng.batch_config(ctx, U)
    return sign_bucket_label(bcfg) if bcfg else ""


def _select_by_cost(ctx: EngineContext, arr: np.ndarray, bucket: int,
                    ct: CostTable) -> Optional[Engine]:
    """Measured-cost route: the cheapest auto candidate at this batch's
    (bucket, sign) — or None unless EVERY candidate has a granular
    measurement (an unmeasured engine is an unwarmed one, and a
    measurement against nothing is no comparison)."""
    best, best_c = None, None
    for name in auto_candidates(ctx.device):
        eng = get_engine(name)
        c = ct.predict(name, bucket, cost_label(eng, ctx, arr),
                       granular_only=True)
        if c is None:
            return None
        if best_c is None or c < best_c:
            best, best_c = eng, c
    return best


def select_engine(ctx: EngineContext, U,
                  cost_table: Optional[CostTable] = None) -> Engine:
    """The ``auto`` policy: pick an engine for this query batch.

    MEASURED route first: when a :class:`CostTable` (the explicit
    argument, or the context's own) has an observed per-query cost for
    every auto candidate at this batch's (power-of-two bucket, sign
    bucket), the cheapest wins.

    COLD fallback, from host statistics: batch sparsity (sparse queries
    collapse TA's rounds to the active lists), the batch size (the
    batched list scan amortises from ``BATCHED_LIST_MIN_B``) and the
    catalogue's norm spectrum (a decaying one lets the norm scan certify
    after a few blocks). The norm scan is ``topk_mips`` for a context on
    the card and ``norm`` on the CPU, so a CPU context picks what the
    reference picks off the TPU. A tensor batch is read to the host once.
    """
    arr = _host_array(U)
    b = 1 if arr.ndim < 2 else arr.shape[0]
    ct = cost_table if cost_table is not None else ctx.cost_table
    if ct is not None:
        eng = _select_by_cost(ctx, arr, batch_bucket(b), ct)
        if eng is not None:
            return eng
    batched_lists = (ctx.resolved_prefix_depth > 0
                     and batch_bucket(b) >= BATCHED_LIST_MIN_B)
    if _host_nnz_frac(arr) < 0.25 and \
            (batched_lists or ctx.resolved_prefix_depth <= 0):
        # sparse queries: TA's rounds collapse to the active lists. With
        # the layout on but the batch too small to amortise the batched
        # scan, fall through to the contiguous norm scan instead
        return get_engine("ta")
    if ctx.norm_decay < 0.5 or not batched_lists:
        return get_engine(_scan_engine(ctx.device))
    return get_engine("bta")


def auto_candidates(device=None) -> List[str]:
    """Engine names :func:`select_engine` can resolve to for a context on
    ``device`` (``None`` = ``cuda``). Warming exactly this set covers
    every dispatch ``auto`` can make. ``naive`` is a candidate of the
    MEASURED route only: its one matmul batches well, and whether a
    pruned scan beats it at a given (bucket, sign) is what the cost table
    answers."""
    return ["ta", "bta", "naive", _scan_engine(device)]


def _auto_dispatch(ctx: EngineContext, U, k: int,
                   budget: Optional[int] = None) -> TopKResult:
    eng = select_engine(ctx, U)
    if budget is not None and not eng.supports_budget:
        # the budget-capable scan over the same contiguous norm order
        eng = get_engine("norm")
    return eng.run(ctx, U, k, budget=budget)


# ---------------------------------------------------------------------------
# Host-only reference oracles (paper Algorithms 1 and 3) as engines
# ---------------------------------------------------------------------------


def _host_oracle_dispatch(one_query):
    """Wrap a numpy oracle ``(T, order_desc, u, k) -> (v, i, n, d)``: the
    catalogue and its lists are read to the host, each query runs there,
    and the result comes back on the context's device."""

    def dispatch(ctx: EngineContext, U, k: int) -> TopKResult:
        T = to_host(ctx.targets)
        od = to_host(ctx.index.order_desc)
        U_np = np.atleast_2d(_host_array(U).astype(np.float32, copy=False))
        b = U_np.shape[0]
        k_eff = min(int(k), T.shape[0])
        vals = np.full((b, k_eff), float("-inf"), np.float32)
        ids = np.full((b, k_eff), -1, np.int32)
        ns = np.zeros((b,), np.int32)
        dep = np.zeros((b,), np.int32)
        for q, u in enumerate(U_np):
            v, i, n, d = one_query(T, od, u, k_eff)
            vals[q, :len(v)] = v
            ids[q, :len(i)] = i
            ns[q], dep[q] = n, d
        dev = ctx.device
        return TopKResult(
            torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(ns).to(dev), torch.from_numpy(dep).to(dev),
            upper=torch.full((b,), NEG_INF, dtype=torch.float32,
                             device=dev))

    return dispatch


def _fagin_one(T, od, u, k):
    v, i, st = fagin_topk_np(T, od, u, k)
    return v, i, st.n_scored, st.depth


def _partial_one(T, od, u, k):
    v, i, st = partial_threshold_topk_np(T, od, u, k)
    # n_items_touched == TA's n_scored (Theorem 4's logic: same item set)
    return v, i, st.n_items_touched, st.depth


# ---------------------------------------------------------------------------
# Memory-traffic estimators (per-query means, from measured counts)
# ---------------------------------------------------------------------------


def _host_mean(x) -> float:
    return float(np.mean(to_host(x)))


def _traffic_dict(ctx: EngineContext, rows_gathered, rows_contiguous):
    r = ctx.rank
    total = rows_gathered + rows_contiguous
    return {
        "rows_gathered": float(rows_gathered),
        "rows_contiguous": float(rows_contiguous),
        "est_bytes_moved": float(total * r * 4),
        "gather_fraction": float(rows_gathered / total) if total else 0.0,
    }


def _naive_traffic(ctx, res):
    return _traffic_dict(ctx, 0.0, float(ctx.num_targets))


def _list_traffic(ctx, res):
    """TA/BTA: depth (list-depth units) splits at the layout prefix.

    Inside the prefix each of the R lists reads its depth range from both
    direction tiles — contiguous, 2x rows. Past it every candidate costs a
    scattered target row plus a same-shape ``rank_by_item`` row for
    freshness. With the layout off the gather path reads one target row a
    candidate and streams the ``[R, M]`` rank array once: M
    row-equivalents a query."""
    r = ctx.rank
    p = ctx.resolved_prefix_depth
    depth = _host_mean(res.depth)
    if p == 0:
        return _traffic_dict(ctx, depth * r, float(ctx.num_targets))
    contig = 2.0 * min(depth, p) * r
    gathered = 2.0 * max(depth - p, 0.0) * r
    return _traffic_dict(ctx, gathered, contig)


def _norm_traffic(ctx, res):
    # depth is rows enumerated in norm order — all contiguous tile reads
    return _traffic_dict(ctx, 0.0, _host_mean(res.depth))


def _host_traffic(ctx, res):
    # item-at-a-time oracles: every scored row is a random access
    return _traffic_dict(ctx, _host_mean(res.n_scored), 0.0)


register_engine(Engine(
    name="naive", make_args=_naive_args, run_args=_naive_run,
    exact=True, needs_index=False, supports_budget=True,
    backend="torch", layout="row_major", traffic=_naive_traffic,
    description="full matmul + stable top-k (the oracle)"))
register_engine(Engine(
    name="ta", make_args=_list_args, run_args=_ta_run,
    exact=True, needs_index=True, supports_budget=True,
    backend="torch", layout="list_major", batch_config=_list_batch_cfg,
    traffic=_list_traffic,
    description="Threshold Algorithm rounds (paper Alg. 2): chunked "
                "steps, sequential-round accounting, batched "
                "sign-specialised list-prefix tiles, then a gather tail "
                "scored by kernel B4 (plain PyTorch on CPU tensors)"))
register_engine(Engine(
    name="bta", make_args=_list_args, run_args=_bta_run,
    exact=True, needs_index=True, supports_budget=True,
    backend="torch", layout="list_major", batch_config=_list_batch_cfg,
    traffic=_list_traffic,
    description="Block Threshold Algorithm: batched sign-specialised "
                "list-prefix tiles, then a gather tail scored by kernel "
                "B4 (plain PyTorch on CPU tensors)"))
register_engine(Engine(
    name="norm", make_args=_norm_args, run_args=_norm_run,
    exact=True, needs_index=True, supports_budget=True,
    backend="torch", layout="norm_major", traffic=_norm_traffic,
    description="Cauchy-Schwarz norm-ordered block scan"))
register_engine(Engine(
    name="norm_sharded", make_args=_norm_sharded_args,
    run_args=_norm_sharded_run, exact=True, needs_index=True,
    backend="torch", layout="norm_sharded", traffic=_norm_traffic,
    description="shared-tile norm scan per shard of a device mesh, with "
                "cross-shard threshold tightening (row-sharded catalogue)"))
register_engine(Engine(
    name="topk_mips", make_args=_topk_mips_args, run_args=_topk_mips_run,
    exact=True, needs_index=True, backend="cuda", layout="norm_major",
    traffic=_norm_traffic,
    description="norm-ordered block scan as a hand-written CUDA kernel "
                "with a two-level pre-screen (plain PyTorch on CPU "
                "tensors)"))
register_engine(Engine(
    name="fagin", dispatch=_host_oracle_dispatch(_fagin_one), exact=True,
    needs_index=True, supports_batch=False, backend="numpy",
    layout="row_major", host_only=True, traffic=_host_traffic,
    description="Fagin's Algorithm (paper Alg. 1; host-only numpy "
                "oracle)"))
register_engine(Engine(
    name="partial", dispatch=_host_oracle_dispatch(_partial_one),
    exact=True, needs_index=True, supports_batch=False, backend="numpy",
    layout="row_major", host_only=True, traffic=_host_traffic,
    description="Partial Threshold Algorithm (paper Alg. 3 / Eq. 4; "
                "host-only numpy oracle)"))
register_engine(Engine(
    name="auto", dispatch=_auto_dispatch, exact=True, needs_index=True,
    supports_budget=True, backend="dispatch",
    description="per-batch pick: measured costs, else host nnz(u), batch "
                "size and the catalogue's norm spectrum"))
