"""Engine registry: every top-K engine behind one name-keyed interface.

The serving layer, the CLI and the tests dispatch through this registry
instead of hand-rolled ``if/elif`` chains. An :class:`Engine` bundles its
batched body with capability metadata (exact? needs the index? budget?
which backend? which layout?), so callers can enumerate and sweep engines.

Engines run against an :class:`EngineContext`: the catalogue on a device
plus lazily built derived state (sorted-list index, layouts, the kernel
catalogue, per-engine arguments) shared across queries.

Registered engines (this slice of the port):

=============  =====  ===========  =======  ===========  =====================
name           exact  needs_index  backend  layout       algorithm
=============  =====  ===========  =======  ===========  =====================
``naive``      yes    no           torch    row_major    full matmul + top-k
``ta``         yes    yes          torch    list_major   Threshold Algorithm
                                                         (paper Alg. 2),
                                                         chunked; tail scored
                                                         by kernel B4
``bta``        yes    yes          torch    list_major   Block Threshold
                                                         Algorithm; tail
                                                         scored by kernel B4
``norm``       yes    yes          torch    norm_major   Cauchy-Schwarz scan
``topk_mips``  yes    yes          cuda     norm_major   the scan as a CUDA
                                                         kernel (two-level
                                                         pre-screen)
=============  =====  ===========  =======  ===========  =====================

Every engine takes a batch (the reference's ``supports_batch`` is True
for all of them). Aliases accepted by :func:`get_engine`:
``threshold -> ta``, ``blocked -> bta``, ``norm_pruned -> norm`` and
``pallas -> topk_mips`` (the reference's name for its kernel engine).

PyTorch runs eagerly and the kernels take their sizes at run time, so
there is no compile cache to key. Batches are still bucketed to powers of
two (:func:`pad_to_bucket`) and the ``norm`` engine still pads its arrays
to the catalogue's M-bucket, exactly as the reference, so results and
pruning statistics match it field for field. ``bta`` and ``ta`` run on
the real M: the reference pads its list arrays only so that one compiled
executable serves every catalogue of a bucket, and its padded results
equal the unpadded scan's. In place of the reference's trace counters,
``topk_mips.launches`` and ``gather_scores.launches`` count the CUDA
kernels' launches, and :attr:`EngineContext.scan_steps` counts the list
scans' loop iterations.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.blocked import (blocked_topk_batched,
                                      blocked_topk_batched_native,
                                      chunked_ta_topk_batched,
                                      chunked_ta_topk_batched_native,
                                      norm_pruned_topk_batched)
from repro_torch.core.driver import NEG_INF, pad_topk
from repro_torch.core.index import TopKIndex, build_index
from repro_torch.core.layout import (DEFAULT_PREFIX_DEPTH,
                                     LIST_LAYOUT_MIN_TARGETS, build_layout,
                                     pad_zero_rows)
from repro_torch.core.naive import TopKResult, naive_topk
from repro_torch.core.strategies import sign_bucket


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


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CostTable:
    """Measured per-(engine, batch-bucket, label) serve cost.

    An EWMA (default ``alpha=0.2``) of observed per-QUERY seconds, keyed
    by engine name, power-of-two batch bucket and a label (empty for every
    engine of this slice). :meth:`predict` falls back label -> engine
    aggregate unless ``granular_only=True``. Thread-safe.
    :meth:`EngineContext.warmup` primes it with one timed run per warmed
    (engine, bucket).
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
            self._ewma[key] = (per_query_s if prev is None
                               else (1 - a) * prev + a * per_query_s)
            prev_e = self._engine.get(engine)
            self._engine[engine] = (per_query_s if prev_e is None
                                    else (1 - a) * prev_e + a * per_query_s)
            self.n_observations += 1

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
      device: where the catalogue and every derived array live
        (``None`` = ``cuda``).

    ``scan_steps`` counts the list scans' loop iterations — each one host
    read — by phase (``"prefix"``, ``"tail"``, ``"gather"``).
    """

    def __init__(self, targets, index: Optional[TopKIndex] = None,
                 block_size: int = 256, max_blocks: int = -1,
                 ta_chunk: int = 32, prefix_depth: Optional[int] = None,
                 cost_table: Optional[CostTable] = None, device=None):
        self.device = resolve_device(device)
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
        self._layouts: Dict[str, object] = {}
        self._engine_args: Dict[str, Any] = {}

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

    def layout(self, name: str):
        """The named catalogue layout, built lazily and cached."""
        lay = self._layouts.get(name)
        if lay is None:
            params = {"device": self.device}
            if name == "list_major":
                params["prefix_depth"] = self.resolved_prefix_depth
            index = None if name == "row_major" else self.index
            lay = build_layout(name, self.targets, index, **params)
            self._layouts[name] = lay
        return lay

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
        res = engine.run_args(self, self.engine_args(engine), U, int(k),
                              budget, bcfg)
        if U.shape[0] != b:
            res = TopKResult(*(x[:b] for x in res))
        return res

    def warmup(self, k: int, batch_sizes=(1, 8, 64),
               engines: Optional[List[str]] = None,
               cost_table: Optional[CostTable] = None) -> "EngineContext":
        """Build every engine's lazy state (index, layouts, kernel
        catalogue, the CUDA library) ahead of traffic by running one
        representative batch per bucket, then prime ``cost_table`` (default:
        the context's own) with one more timed run per (engine, bucket).
        Returns self for chaining."""
        names = list(engines) if engines is not None else engine_names()
        ct = cost_table if cost_table is not None else self.cost_table
        for name in names:
            eng = get_engine(name)
            for b in batch_sizes:
                bucket = batch_bucket(b)
                U = torch.ones((bucket, self.rank), dtype=torch.float32,
                               device=self.device)
                eng.run(self, U, k)
                synchronize(self.device)
                if ct is not None:
                    t0 = time.perf_counter()
                    eng.run(self, U, k)
                    synchronize(self.device)
                    ct.observe(eng.name, bucket, "",
                               (time.perf_counter() - t0) / bucket)
        return self


@dataclasses.dataclass(frozen=True)
class Engine:
    """A registered engine: batched body + capability metadata.

    ``make_args(ctx, m_bucket)`` prepares the engine's arguments from the
    context once (cached by :meth:`EngineContext.engine_args`);
    ``run_args(ctx, args, U, k, budget, bcfg)`` is the batched body over
    a ``[B, R]`` tensor on the context's device. ``batch_config(ctx, U)``,
    where set, is the batch's specialisation (the list engines' sign
    bucket): worked out once per batch and handed to ``run_args`` as
    ``bcfg`` (``()`` for engines without one); the server also records
    it per served batch.
    """

    name: str
    make_args: Callable[[EngineContext, int], Any]
    run_args: Callable[[EngineContext, Any, torch.Tensor, int,
                        Optional[int], tuple], TopKResult]
    exact: bool = True
    needs_index: bool = True
    #: True for engines that honour ``run(..., budget=)`` — a halting
    #: budget in rows (norm-order rows; list depth for ``bta``, rounded
    #: up to whole blocks; rounds for ``ta``), with the halted result
    #: carrying a per-item certificate bound (``TopKResult.upper``)
    supports_budget: bool = False
    backend: str = "torch"
    layout: Optional[str] = None
    batch_config: Optional[Callable[[EngineContext, Any], tuple]] = None
    description: str = ""

    def run(self, ctx: EngineContext, U, k: int,
            budget: Optional[int] = None,
            bcfg: Optional[tuple] = None) -> TopKResult:
        if budget is not None and not self.supports_budget:
            raise ValueError(
                f"engine {self.name!r} does not support budgeted queries; "
                "use one of "
                f"{[e.name for e in list_engines() if e.supports_budget]}")
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


register_engine(Engine(
    name="naive", make_args=_naive_args, run_args=_naive_run,
    exact=True, needs_index=False, supports_budget=True,
    backend="torch", layout="row_major",
    description="full matmul + stable top-k (the oracle)"))
register_engine(Engine(
    name="ta", make_args=_list_args, run_args=_ta_run,
    exact=True, needs_index=True, supports_budget=True,
    backend="torch", layout="list_major", batch_config=_list_batch_cfg,
    description="Threshold Algorithm rounds (paper Alg. 2): chunked "
                "steps, sequential-round accounting, batched "
                "sign-specialised list-prefix tiles, then a gather tail "
                "scored by kernel B4 (plain PyTorch on CPU tensors)"))
register_engine(Engine(
    name="bta", make_args=_list_args, run_args=_bta_run,
    exact=True, needs_index=True, supports_budget=True,
    backend="torch", layout="list_major", batch_config=_list_batch_cfg,
    description="Block Threshold Algorithm: batched sign-specialised "
                "list-prefix tiles, then a gather tail scored by kernel "
                "B4 (plain PyTorch on CPU tensors)"))
register_engine(Engine(
    name="norm", make_args=_norm_args, run_args=_norm_run,
    exact=True, needs_index=True, supports_budget=True,
    backend="torch", layout="norm_major",
    description="Cauchy-Schwarz norm-ordered block scan"))
register_engine(Engine(
    name="topk_mips", make_args=_topk_mips_args, run_args=_topk_mips_run,
    exact=True, needs_index=True, backend="cuda", layout="norm_major",
    description="norm-ordered block scan as a hand-written CUDA kernel "
                "with a two-level pre-screen (plain PyTorch on CPU "
                "tensors)"))
