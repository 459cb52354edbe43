"""Streaming catalogue: segmented (base + delta) exact top-K (DESIGN.md §9).

The paper's pruned scans assume a *static* catalogue: the sorted lists,
the norm order and every layout of :mod:`repro_torch.core.layout` are
built offline. A retrieval tier must absorb inserts, updates and deletes
without an index rebuild per mutation and without giving up exactness.
This module is the port of the reference's single-level answer
(``core/segments.py``); the LSM ladder
(:class:`repro_torch.core.lsm.ShardedLsmCatalogue`) subclasses it through
the L1 hooks below, which return the single-level values here.

* **Base segment** — an immutable snapshot: an
  :class:`repro_torch.core.engines.EngineContext` on the catalogue's
  device plus the row -> global-id map. Queries run any registry engine
  over it.
* **Delta segment** — a fixed-capacity host buffer of inserted rows,
  never indexed: every query scores its live slots densely with one
  ``[B, R] @ [R, D]`` product on the device. The device view is padded to
  a power-of-four occupancy bucket and is a COPY of the host buffer, so a
  later append never changes a view a query holds.
* **Tombstones** — deletes (and the delete half of updates) mark the row
  dead where it lives: a ``[M_base]`` mask over the snapshot, updated
  functionally (a new tensor per kill batch, so a query in flight keeps
  the mask it captured), and a per-slot mask over the delta. The base
  fetch is tombstone-adaptive: plain ``k`` while the snapshot has no dead
  rows, ``k + reserve`` once it has, and a x4 escalation ladder only
  while some query's dropped count exceeds its over-fetch margin
  (``dropped > k_base - k``); a full-base fetch is exact
  unconditionally.
* **Merge** — the dropped-and-resorted base list and each delta
  segment's dense scores fold through the two-stage merge every engine
  uses (:func:`repro_torch.core.driver.merge_block_into_carry_batched`).
  Both the delta scoring and the merge are plain PyTorch: the reference
  computes them outside any Pallas kernel. The LSM ladder's L1 tier
  merges first, shard by shard (:func:`_segmented_tail`).
* **Compaction** — when the delta fills (or tombstones pass a threshold)
  the live rows of base + delta fold into a FRESH snapshot under the next
  ``version``: a new context on the device whose lazy state (index,
  layouts, kernel catalogue of every engine the old snapshot had
  prepared, and the warm spec's engines run once) the build readies
  before the swap. ``compact_async=True`` builds on a background
  thread; its work runs on the default CUDA stream. Deletes that land
  during a build are re-applied at the swap.

**Streams.** The catalogue's tensors are made and read on the current
CUDA stream, the default one for every thread of the port: mutations,
delta and L1 views, a compaction's build and every query, the async
tier's included. One stream orders them all, so no query reads a tensor
before the kernel that wrote it has run, and the caching allocator
reuses freed memory only behind the work that read it.

The port has no trace cache: ``SegmentStats.engine_compiles_total``
counts the kernel library loads a build's readiness pass caused
(:func:`repro_torch.kernels._build.loads_total`), 0 once the libraries
are loaded. ``n_scored`` adds the live delta slots scored; ``depth`` is
the base engine's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import faults
from repro_torch.core.driver import (NEG_INF, merge_block_into_carry_batched,
                                     pad_topk)
from repro_torch.core.engines import (Engine, EngineContext, batch_bucket,
                                      get_engine, pad_to_bucket)
from repro_torch.core.naive import TopKResult, stable_topk
from repro_torch.core.sharded import shard_fold_topk

# Named fault points (DESIGN.md §12): no-ops until a test arms them via
# repro_torch.core.faults.
FAULT_BUILD = faults.register_point(
    "compaction.build",
    "raise inside the compaction builder before the snapshot swap")
FAULT_STALL = faults.register_point(
    "compaction.stall",
    "sleep inside the compaction builder (slow/stuck build)")
FAULT_WARM = faults.register_point(
    "compaction.warm",
    "raise during the post-build readiness warmup")
FAULT_DELTA_OVERFLOW = faults.register_point(
    "delta.overflow",
    "report the active delta as full on an append (mutation burst)")

#: Default delta-buffer capacity (rows). Power of two; a full delta
#: triggers compaction.
DEFAULT_DELTA_CAPACITY = 256

#: Compact when dead base rows exceed this fraction of the base.
DEFAULT_TOMBSTONE_COMPACT_FRACTION = 0.25

#: Absolute tombstone count that triggers compaction regardless of the
#: base size; ``None`` couples it to ``2 * delta_capacity``.
DEFAULT_MAX_TOMBSTONES = None

#: First rung of the escalation ladder: a tombstoned snapshot fetches
#: ``k + reserve``, then climbs x4 per rung only while some query's
#: dropped count exceeds the over-fetch margin.
DEFAULT_OVERFETCH_RESERVE = 32

#: Ladder growth factor between escalation rungs.
ESCALATION_STEP = 4


def delta_bucket(n: int) -> int:
    """Power-of-FOUR device-view bucket for ``n`` delta rows (min 1)."""
    b = 1
    while b < n:
        b <<= 2
    return b


@dataclasses.dataclass(frozen=True)
class QueryInfo:
    """Side-channel accounting for one segmented query batch.

    Attributes:
      delta_scored: live delta slots dense-scored per query (added into
        the returned ``TopKResult.n_scored``).
      overfetch_k: the ``k`` of the AUTHORITATIVE base engine run — plain
        ``k`` with no tombstones, ``k + reserve`` while any base row is
        dead, higher (x4 per climb) only when a query had more than
        ``reserve`` dead rows inside its fetched slice.
      n_segments: delta segments scored (0 pristine, 1 steady state, more
        while a build has sealed segments in flight).
      version: snapshot version the batch was served from.
      retried: True when the first fetch was discarded and the batch
        re-ran up the escalation ladder.
    """

    delta_scored: int
    overfetch_k: int
    n_segments: int
    version: int
    retried: bool = False


@dataclasses.dataclass
class SegmentStats:
    """Cumulative mutation/compaction counters (monotonic).

    ``engine_compiles_total`` counts the kernel library loads (the port's
    compiles) that compaction builds' readiness passes caused, attributed
    from each new context's own ``trace_counts``: 0 once the libraries
    are loaded. The port has no per-M-bucket executables, so no build
    pre-pays a next bucket and ``headroom_compiles_total`` stays 0.
    ``compaction_s_total``/``last_compaction_s`` time the whole build.
    The L1 counters belong to the LSM ladder and stay 0 on the
    single-level catalogue.
    """

    n_inserts: int = 0
    n_deletes: int = 0
    n_updates: int = 0
    n_compactions: int = 0
    n_failed_compactions: int = 0
    max_delta_occupancy: int = 0
    engine_compiles_total: int = 0
    headroom_compiles_total: int = 0
    compaction_s_total: float = 0.0
    last_compaction_s: float = 0.0
    # recovery counters (DESIGN.md §12)
    n_build_retries: int = 0
    n_forced_sync_compactions: int = 0
    n_stuck_builds: int = 0
    max_l0_chain: int = 0
    # LSM ladder counters (DESIGN.md §15): zero on this catalogue
    n_l1_folds: int = 0
    n_failed_l1_folds: int = 0
    n_l1_fold_retries: int = 0
    l1_fold_s_total: float = 0.0


class Snapshot:
    """One immutable base segment: an EngineContext + the row/gid maps.

    The rows never change after construction; only the tombstone mask
    does, and its device copy is REPLACED on each kill batch (never
    written in place), so a query that captured the previous mask keeps
    it.
    """

    def __init__(self, targets_np: np.ndarray, gids_np: np.ndarray,
                 version: int, ctx: EngineContext):
        self.targets_np = targets_np          # [Mb, R] float32 (host copy)
        self.gids_np = gids_np.astype(np.int64)
        self.version = int(version)
        self.ctx = ctx
        mb = targets_np.shape[0]
        dev = ctx.device
        self.gids_dev = torch.tensor(gids_np.astype(np.int32), device=dev)
        self.dead_np = np.zeros((mb,), bool)
        self.dead_dev = torch.zeros((mb,), dtype=torch.bool, device=dev)
        self.n_dead = 0
        self.gid_to_row = {int(g): i for i, g in enumerate(self.gids_np)}
        # identity snapshots (gid i lives at row i) can serve the
        # never-mutated fast path with raw engine indices
        self.identity = bool(
            mb == 0 or np.array_equal(self.gids_np, np.arange(mb)))

    @property
    def num_rows(self) -> int:
        return int(self.targets_np.shape[0])

    def kill_rows(self, rows: Sequence[int]) -> None:
        rows = np.asarray(list(rows), np.int64)
        fresh = ~self.dead_np[rows]
        self.dead_np[rows] = True
        # out of place: a new mask tensor, the captured one stays as it was
        dev = self.dead_dev.device
        self.dead_dev = self.dead_dev.index_fill(
            0, torch.from_numpy(rows).to(dev), True)
        self.n_dead += int(np.sum(fresh))


class DeltaSegment:
    """Fixed-capacity append buffer of (row, gid) pairs with a dead mask.

    The host arrays are the state; :meth:`device_view` uploads a COPY
    padded to the power-of-four bucket covering the occupancy
    (:func:`delta_bucket`). ``seal()`` freezes the segment for a
    compaction — further appends are a bug (asserted).
    """

    def __init__(self, capacity: int, rank: int, device: torch.device):
        cap = batch_bucket(capacity)          # power-of-two storage
        self.capacity = cap
        self.device = device
        self.rows = np.zeros((cap, rank), np.float32)
        self.gids = np.full((cap,), -1, np.int64)
        self.dead = np.zeros((cap,), bool)
        self.count = 0
        self.sealed = False
        self._pos: Dict[int, int] = {}        # live gid -> slot
        self._dev: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def n_live(self) -> int:
        return self.count - int(np.sum(self.dead[:self.count]))

    @property
    def full(self) -> bool:
        return self.count >= self.capacity

    def append(self, row: np.ndarray, gid: int) -> int:
        assert not self.sealed, "appending to a sealed (compacting) delta"
        assert self.count < self.capacity
        slot = self.count
        self.rows[slot] = row
        self.gids[slot] = gid
        self._pos[gid] = slot
        self.count += 1
        self._dev = None
        return slot

    def kill(self, gid: int) -> None:
        slot = self._pos.pop(gid)
        self.dead[slot] = True
        self._dev = None

    def seal(self) -> None:
        self.sealed = True
        self._dev = None          # rebuild the view at the capacity bucket

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        live = ~self.dead[:self.count]
        return (self.rows[:self.count][live].copy(),
                self.gids[:self.count][live].copy())

    def device_view(self) -> Tuple[torch.Tensor, ...]:
        """``(rows [D, R], gids [D], live [D])`` padded to the pow4 bucket
        (a sealed segment presents its full capacity, as the
        reference's). ``torch.tensor`` copies, so the view never shares
        memory with the host buffers an append writes."""
        if self._dev is None:
            d = (self.capacity if self.sealed
                 else min(delta_bucket(max(self.count, 1)), self.capacity))
            live = np.zeros((d,), bool)
            live[:self.count] = ~self.dead[:self.count]
            dev = self.device
            self._dev = (torch.tensor(self.rows[:d], device=dev),
                         torch.tensor(self.gids[:d].astype(np.int32),
                                      device=dev),
                         torch.tensor(live, device=dev))
        return self._dev


def _segmented_tail(base_vals, tomb, base_gids, U, segs, l1=None, *,
                    k: int, kb: int):
    """Drop tombstones from the base top-``kb``, fold in the delta segments.

    ``base_vals [B, kb]`` is the base engine's exact top-``kb``
    (descending), ``tomb [B, kb]`` flags the tombstoned entries and
    ``base_gids [B, kb]`` carries the global ids (``-1`` for engine
    padding), both resolved on the device by the caller. The survivors
    are re-topped to ``k`` (a stable sort: ties keep the engine's order),
    then each delta segment's dense scores merge in, the carry first
    (ties go to the base, as in the reference).

    ``l1`` is the LSM ladder's per-shard L1 tier: ``None`` for the
    single-level catalogue, else ``(rows [S, C, R], gids [S, C], live [S,
    C])`` at the full per-shard run capacity. One ``[B, R] x [S, C, R]``
    einsum scores every run densely, and the runs fold through
    :func:`repro_torch.core.sharded.shard_fold_topk` (each shard's block
    cut to k, shard 0 first) BEFORE the L0 chain and the active delta:
    the merge order is the ladder's age order, as in the reference, and
    so are the ids under ties.

    Returns ``(values, gids, n_dropped)``; ``n_dropped [B]`` counts the
    TOMBSTONED base rows inside the top-``kb`` (engine padding is not a
    drop).
    """
    drop = (base_gids < 0) | tomb
    n_dropped = tomb.sum(dim=1, dtype=torch.int32)
    v = torch.where(drop, NEG_INF, base_vals)
    gi = torch.where(drop, -1, base_gids)
    v, pos = stable_topk(v, min(k, kb))
    gi = torch.gather(gi, 1, pos)
    v, gi = pad_topk(v, gi, k)                # base smaller than k
    if l1 is not None:
        l1_rows, l1_gids, l1_live = l1
        l1_scores = torch.einsum("br,scr->sbc", U, l1_rows)
        l1_scores = torch.where(l1_live[:, None, :], l1_scores, NEG_INF)
        v, gi = shard_fold_topk(v, gi, l1_scores, l1_gids, k)
    for rows, gid, live in segs:
        scores = U @ rows.T                   # [B, D] — one dense product
        scores = torch.where(live[None, :], scores, NEG_INF)
        v, gi = merge_block_into_carry_batched(v, gi, scores, gid, k)
    return v, gi, n_dropped


class SegmentedCatalogue:
    """Base snapshot + delta buffer + tombstones: exact streaming top-K.

    Thread-safe for one writer + concurrent readers (a single lock guards
    the mutable maps; queries copy references out under it and compute
    outside it). All mutation entry points may trigger compaction;
    queries never do.

    Args:
      targets: initial ``[M, R]`` catalogue (global ids ``0..M-1``).
      delta_capacity: delta-buffer rows (rounded up to a power of two).
      tombstone_compact_fraction: compact once dead base rows exceed
        this fraction of the base.
      max_tombstones: absolute dead-row count that triggers compaction;
        ``None`` uses ``2 * delta_capacity``.
      overfetch_reserve: first escalation rung (``k + reserve``).
      compact_async: build replacement snapshots on a background thread.
      max_l0_segments: cap on the sealed-segment chain; past it a
        mutation forces a SYNCHRONOUS compaction (DESIGN.md §12).
      build_retry_limit: consecutive failed builds after which automatic
        retries stop (explicit :meth:`compact` and the chain cap still
        force attempts).
      build_backoff_s: initial retry backoff after a failed build,
        doubling per consecutive failure up to ``build_backoff_max_s``.
      build_watchdog_s: a background build older than this is flagged as
        STUCK (``SegmentStats.n_stuck_builds``); detection only.
      auto_retry: a failed async build schedules its own timed retry.
      ctx_kwargs: forwarded to every :class:`EngineContext` this
        catalogue builds (``block_size``, ``prefix_depth``, ``device``,
        ...; ``device=None`` means ``cuda``).
    """

    def __init__(self, targets, *,
                 delta_capacity: int = DEFAULT_DELTA_CAPACITY,
                 tombstone_compact_fraction: float =
                 DEFAULT_TOMBSTONE_COMPACT_FRACTION,
                 max_tombstones: Optional[int] = DEFAULT_MAX_TOMBSTONES,
                 overfetch_reserve: int = DEFAULT_OVERFETCH_RESERVE,
                 compact_async: bool = False,
                 max_l0_segments: int = 4,
                 build_retry_limit: int = 3,
                 build_backoff_s: float = 0.05,
                 build_backoff_max_s: float = 2.0,
                 build_watchdog_s: float = 30.0,
                 auto_retry: bool = False, **ctx_kwargs):
        if isinstance(targets, torch.Tensor):
            targets = targets.detach().cpu().numpy()
        T = np.ascontiguousarray(np.asarray(targets, np.float32))
        self.rank = int(T.shape[1])
        self.delta_capacity = batch_bucket(max(int(delta_capacity), 1))
        self.tombstone_compact_fraction = float(tombstone_compact_fraction)
        if max_tombstones is None:
            max_tombstones = 2 * self.delta_capacity
        self.max_tombstones = int(max_tombstones)
        self.overfetch_reserve = batch_bucket(max(int(overfetch_reserve), 1))
        self.compact_async = bool(compact_async)
        self.max_l0_segments = max(int(max_l0_segments), 1)
        self.build_retry_limit = max(int(build_retry_limit), 0)
        self.build_backoff_s = float(build_backoff_s)
        self.build_backoff_max_s = float(build_backoff_max_s)
        self.build_watchdog_s = float(build_watchdog_s)
        # a FAILED async build schedules its own timed retry; off by
        # default, so retries ride the next compaction trigger
        self.auto_retry = bool(auto_retry)
        self.device = resolve_device(ctx_kwargs.pop("device", None))
        self._ctx_kwargs = dict(ctx_kwargs, device=self.device)
        self._lock = threading.RLock()
        self._snapshot = Snapshot(
            T, np.arange(T.shape[0], dtype=np.int64), 0,
            EngineContext(T, version=0, **self._ctx_kwargs))
        self._delta = self._new_delta()
        # sealed segments awaiting compaction (an L0 chain: normally one,
        # more only if a background build failed — sealed segments stay
        # queryable and fold on the next compaction)
        self._frozen: List[DeltaSegment] = []
        self._next_gid = int(T.shape[0])
        self._pending_dead: set = set()       # deletes landed mid-build
        self._build_thread: Optional[threading.Thread] = None
        self.stats = SegmentStats()
        self.last_build_error: Optional[BaseException] = None
        # build-failure recovery state machine (DESIGN.md §12)
        self._consec_build_failures = 0
        self._retry_not_before = 0.0          # monotonic deadline (backoff)
        self._last_backoff_s = 0.0
        self._retry_timer: Optional[threading.Timer] = None
        self._build_started_at: Optional[float] = None
        self._watchdog_flagged = False
        self._warm_spec: Optional[tuple] = None
        # mutation epoch: bumped under the lock by EVERY visible mutation
        # (append/tombstone/update and the compaction swap). (version,
        # epoch) is the result-cache token (DESIGN.md §13).
        self._epoch = 0
        self._invalidation_listeners: List[Callable[[], None]] = []

    def _new_delta(self) -> DeltaSegment:
        return DeltaSegment(self.delta_capacity, self.rank, self.device)

    # -- introspection -------------------------------------------------------

    @property
    def snapshot(self) -> Snapshot:
        return self._snapshot

    @property
    def version(self) -> int:
        return self._snapshot.version

    def _segments(self) -> List[DeltaSegment]:
        """Sealed segments (oldest first) + the active delta. Lock held."""
        return [*self._frozen, self._delta]

    def cache_token(self) -> Tuple[int, int]:
        """``(snapshot version, mutation epoch)`` — the identity of the
        currently visible contents; compare tokens for equality only."""
        with self._lock:
            return (self._snapshot.version, self._epoch)

    def add_invalidation_listener(self, fn: Callable[[], None]) -> None:
        """Register ``fn`` to run after every visible mutation (append,
        tombstone, update, compaction swap). Listeners may fire while a
        mutating caller holds the catalogue lock, so they must not call
        back into the catalogue."""
        with self._lock:
            self._invalidation_listeners.append(fn)

    def _bump_epoch_locked(self, kind: str) -> None:
        self._epoch += 1
        obs.on_epoch_bump(kind, self._snapshot.version, self._epoch)

    def _notify_invalidation(self) -> None:
        with self._lock:
            listeners = list(self._invalidation_listeners)
        for fn in listeners:
            fn()

    @property
    def delta_occupancy(self) -> int:
        with self._lock:
            return sum(seg.count for seg in self._segments())

    @property
    def n_tombstones(self) -> int:
        with self._lock:
            return self._snapshot.n_dead + sum(
                int(np.sum(seg.dead[:seg.count]))
                for seg in self._segments())

    @property
    def num_live(self) -> int:
        with self._lock:
            return (self._snapshot.num_rows - self._snapshot.n_dead
                    + sum(seg.n_live for seg in self._segments()))

    @property
    def pristine(self) -> bool:
        """No mutation is visible: raw engine results need no rewriting."""
        with self._lock:
            return (self._snapshot.identity and self._snapshot.n_dead == 0
                    and not self._frozen and self._delta.count == 0)

    @property
    def l0_chain_len(self) -> int:
        """Sealed segments currently awaiting compaction."""
        with self._lock:
            return len(self._frozen)

    # -- L1-tier hooks (single-level here; the LSM ladder overrides them) ----

    def _l1_stack_locked(self):
        """The stacked per-shard L1 device view, or ``None``. Lock held."""
        return None

    def _l1_live_locked(self) -> int:
        """Live rows resident in the L1 tier. Lock held."""
        return 0

    def _chain_pressure_locked(self) -> int:
        """Sealed segments counted against ``max_l0_segments``. The LSM
        ladder leaves out the L1 runs an in-flight promotion parks in the
        chain: queries already scored those rows through the L1 tier, so
        they add no pressure. Lock held."""
        return len(self._frozen)

    @property
    def n_shards(self) -> int:
        """L1 shard count (0: single-level, no L1 tier)."""
        return 0

    @property
    def l1_rows(self) -> int:
        """Live rows resident in the per-shard L1 tier (none here)."""
        return 0

    @property
    def consecutive_fold_failures(self) -> int:
        return 0

    @property
    def fold_backoff_s(self) -> float:
        return 0.0

    @property
    def consecutive_build_failures(self) -> int:
        with self._lock:
            return self._consec_build_failures

    @property
    def current_backoff_s(self) -> float:
        """The backoff the NEXT automatic retry is waiting out (0 when the
        last build succeeded)."""
        with self._lock:
            return self._last_backoff_s if self._consec_build_failures \
                else 0.0

    @property
    def retry_pending(self) -> bool:
        """True while an automatic post-failure retry is scheduled."""
        with self._lock:
            return self._retry_timer is not None

    def check_watchdog(self) -> bool:
        """Flag (once per build) an in-flight build past the watchdog
        threshold. Returns True while the build is overdue. Detection
        only: the thread is never killed."""
        with self._lock:
            started = self._build_started_at
            if self._build_thread is None or started is None:
                return False
            if time.monotonic() - started <= self.build_watchdog_s:
                return False
            if not self._watchdog_flagged:
                self._watchdog_flagged = True
                self.stats.n_stuck_builds += 1
                obs.on_compaction(
                    "stuck", version=self._snapshot.version,
                    overdue_s=time.monotonic() - started)
            return True

    def _live_concat_locked(self, snap: Snapshot, segs
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Base live rows + each segment's live rows, concatenated: THE
        liveness fold shared by :meth:`as_dense` and compaction. Lock
        held."""
        parts_r: List[np.ndarray] = [snap.targets_np[~snap.dead_np]]
        parts_g: List[np.ndarray] = [snap.gids_np[~snap.dead_np]]
        for seg in segs:
            if seg.count:
                r, g = seg.live_rows()
                parts_r.append(r)
                parts_g.append(g)
        return (np.concatenate(parts_r, axis=0),
                np.concatenate(parts_g, axis=0))

    def as_dense(self) -> Tuple[np.ndarray, np.ndarray]:
        """A consistent host ``(rows [N, R], gids [N])`` view of every
        LIVE item — what a from-scratch rebuild would index."""
        with self._lock:
            return self._live_concat_locked(self._snapshot,
                                            self._segments())

    # -- mutations -----------------------------------------------------------

    def _locate(self, gid: int):
        """(where, segment-or-row) for a LIVE gid; KeyError if not live."""
        if gid in self._delta._pos:
            return "delta", self._delta
        for frozen in self._frozen:
            if gid in frozen._pos:
                return "frozen", frozen
        row = self._snapshot.gid_to_row.get(gid)
        if row is not None and not self._snapshot.dead_np[row]:
            return "base", row
        raise KeyError(f"gid {gid} is not a live catalogue item")

    def _kill_located(self, located) -> None:
        """Apply a validated batch of (gid, where, seg-or-row) kills; base
        kills go in ONE mask update. Lock held."""
        base_rows: List[int] = []
        for gid, where, seg in located:
            if where == "base":
                base_rows.append(seg)
                if self._build_thread is not None:
                    self._pending_dead.add(gid)
            else:
                seg.kill(gid)
                if where == "frozen":
                    self._pending_dead.add(gid)
        if base_rows:
            self._snapshot.kill_rows(base_rows)

    def _note_delta_peak(self) -> None:
        self.stats.max_delta_occupancy = max(
            self.stats.max_delta_occupancy, self._delta.count)

    def _validate_rows(self, rows, what: str) -> np.ndarray:
        """Shape, rank and finiteness of mutation input: a NaN/Inf row
        would poison every score it takes part in."""
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        R = np.atleast_2d(np.asarray(rows, np.float32))
        if R.ndim != 2:
            raise ValueError(
                f"{what} must be [R] or [N, R], got shape {R.shape}")
        if R.shape[1] != self.rank:
            raise ValueError(f"rank mismatch: {R.shape[1]} != {self.rank}")
        if not np.all(np.isfinite(R)):
            bad = int(np.flatnonzero(~np.all(np.isfinite(R), axis=1))[0])
            raise ValueError(
                f"{what} contain non-finite values (first bad row: {bad}); "
                "NaN/Inf rows would corrupt every top-K they score in")
        return R

    def add_targets(self, rows) -> np.ndarray:
        """Append rows; returns their freshly assigned global ids."""
        R = self._validate_rows(rows, "inserted rows")
        out = np.empty((R.shape[0],), np.int64)
        with self._lock:
            for i, row in enumerate(R):
                if self._delta.full or faults.fire(FAULT_DELTA_OVERFLOW):
                    self._compact_locked()
                gid = self._next_gid
                self._next_gid += 1
                self._delta.append(row, gid)
                self._note_delta_peak()
                out[i] = gid
            self.stats.n_inserts += R.shape[0]
            self._bump_epoch_locked("insert")
        self._after_mutation()
        return out

    def delete_targets(self, gids) -> None:
        """Tombstone live items. Validate-then-apply: every gid is located
        before anything changes, so a KeyError (unknown, dead or
        duplicate gid) leaves the catalogue untouched."""
        gids = [int(g) for g in np.atleast_1d(np.asarray(gids))]
        with self._lock:
            if len(set(gids)) != len(gids):
                raise KeyError(f"duplicate gids in delete batch: {gids}")
            located = [(gid, *self._locate(gid)) for gid in gids]
            self._kill_located(located)
            self.stats.n_deletes += len(gids)
            self._bump_epoch_locked("delete")
            self._maybe_compact_locked()
        self._after_mutation()

    def update_targets(self, gids, rows) -> None:
        """Replace live items: tombstone the old row, append the new one
        to the delta under the SAME gid. Validate-then-apply; a repeated
        gid is allowed and the LAST row wins."""
        gids = [int(g) for g in np.atleast_1d(np.asarray(gids))]
        R = self._validate_rows(rows, "updated rows")
        if len(gids) != R.shape[0]:
            raise ValueError("one row per gid required")
        with self._lock:
            seen: set = set()
            located = []
            for gid in gids:
                if gid not in seen:            # later copies shadow below
                    seen.add(gid)
                    located.append((gid, *self._locate(gid)))
            self._kill_located(located)
            for gid, row in zip(gids, R):
                try:
                    loc = self._locate(gid)
                except KeyError:
                    pass                       # first append for this gid
                else:
                    # same gid earlier in THIS batch (its copy may since
                    # have been frozen or folded): the last row wins
                    self._kill_located([(gid, *loc)])
                if self._delta.full or faults.fire(FAULT_DELTA_OVERFLOW):
                    self._compact_locked()
                self._delta.append(row, gid)
                self._note_delta_peak()
            self.stats.n_updates += len(gids)
            self._bump_epoch_locked("update")
            self._maybe_compact_locked()
        self._after_mutation()

    # -- compaction ----------------------------------------------------------

    def _maybe_compact_locked(self) -> None:
        snap = self._snapshot
        thresh = min(float(self.max_tombstones),
                     self.tombstone_compact_fraction * max(snap.num_rows, 1))
        if self._delta.full or (snap.n_dead and snap.n_dead >= thresh):
            self._compact_locked()

    def _after_mutation(self) -> None:
        """Post-mutation hooks that must run OFF the lock: the chain cap
        may join a build thread, which takes the lock to swap."""
        self._notify_invalidation()
        self.check_watchdog()
        self._enforce_chain_cap()

    def _enforce_chain_cap(self) -> None:
        """Force the L0 chain back under ``max_l0_segments``: join the
        in-flight build, else run a forced SYNCHRONOUS build inline
        (bypassing the backoff). Gives up after ``build_retry_limit + 1``
        consecutive inline failures (the chain stays queryable)."""
        attempts = 0
        while True:
            with self._lock:
                if self._chain_pressure_locked() <= self.max_l0_segments:
                    return
                t = self._build_thread
                if t is None:
                    if attempts > self.build_retry_limit:
                        return
                    attempts += 1
                    self.stats.n_forced_sync_compactions += 1
                    obs.on_compaction("forced_sync",
                                      chain_len=len(self._frozen),
                                      attempt=attempts)
                    self._compact_locked(force=True, force_sync=True)
                    continue
            t.join()        # off-lock: the build takes the lock to swap

    def _retry_build(self) -> None:
        """Timer target: the automatic post-failure retry (async mode)."""
        with self._lock:
            self._retry_timer = None
            if self._build_thread is not None:
                return
            if (self._frozen or self._delta.count
                    or self._snapshot.n_dead):
                # force=True: the elapsed timer IS the backoff
                self._compact_locked(force=True)

    def _ready(self, ctx: EngineContext, old: EngineContext,
               n_rows: int) -> int:
        """The build's readiness pass over a new snapshot's context,
        before the swap: build the index and the arguments (layouts,
        kernel catalogue) of every engine the old snapshot had prepared,
        and with a warm spec run each warmed engine at the serving ``k``
        and the over-fetched one, so the first query after the swap finds
        its state on the device. Returns the kernel library loads it
        caused (the port's compiles)."""
        ctx.index                             # offline index build
        for name in old.prepared_engines:
            ctx.engine_args(get_engine(name))
        if self._warm_spec is None:
            return 0
        k, sizes, engines, budgets = self._warm_spec
        ctx.warmup(k, batch_sizes=sizes, engines=engines, budgets=budgets)
        kb_esc = min(n_rows, int(k) + self.overfetch_reserve)
        if engines and kb_esc > min(n_rows, int(k)):
            ctx.warmup(kb_esc, batch_sizes=sizes, engines=engines,
                       budgets=budgets)
        return sum(ctx.trace_counts.values())

    def _backoff_after(self, streak: int) -> float:
        """Retry backoff after ``streak`` consecutive failures: doubling
        from ``build_backoff_s``, capped at ``build_backoff_max_s``."""
        return min(self.build_backoff_s * (2 ** (streak - 1)),
                   self.build_backoff_max_s)

    def _retry_gated(self, streak: int, not_before: float) -> bool:
        """True when no automatic attempt may run after ``streak``
        consecutive failures: past the retry limit, or, from the second
        failure on, before the backoff deadline ``not_before``."""
        return bool(streak) and (
            streak > self.build_retry_limit
            or (streak >= 2 and time.monotonic() < not_before))

    def _record_build_failure_locked(self, exc: BaseException,
                                     version: int) -> float:
        """Record a failed build of ``version`` (lock held): the error,
        the counters, the backoff deadline and the ``fail`` event.
        Returns the backoff."""
        self.last_build_error = exc
        self.stats.n_failed_compactions += 1
        self._consec_build_failures += 1
        backoff = self._backoff_after(self._consec_build_failures)
        self._last_backoff_s = backoff
        self._retry_not_before = time.monotonic() + backoff
        obs.on_compaction(
            "fail", version_attempted=version, epoch=self._epoch,
            error=repr(exc),
            consecutive_failures=self._consec_build_failures,
            backoff_s=backoff)
        return backoff

    def _compact_locked(self, force: bool = False,
                        force_sync: bool = False) -> None:
        """Freeze the active delta and rebuild (inline or on a thread).

        Never blocks and never releases the lock: with a build in flight
        the freshly sealed delta joins the chain and this returns. A
        build folds the ENTIRE chain as of its freeze point; a failed
        build leaves the sealed segments in place (queryable, refolded
        later). After a failure, new attempts wait out an exponential
        backoff and stop after ``build_retry_limit`` consecutive failures;
        ``force=True`` bypasses that gate and ``force_sync=True`` runs the
        build inline even in ``compact_async`` mode.
        """
        if (self._delta.count == 0 and not self._frozen
                and self._snapshot.n_dead == 0):
            return                            # nothing to fold: cheap no-op
        if self._delta.count > 0 or not self._frozen:
            sealed = self._delta
            sealed.seal()
            self._frozen.append(sealed)
            self._delta = self._new_delta()
            self.stats.max_l0_chain = max(self.stats.max_l0_chain,
                                          len(self._frozen))
        if self._build_thread is not None:
            return                            # in-flight build; chain waits
        if not force and self._retry_gated(self._consec_build_failures,
                                           self._retry_not_before):
            return
        snap = self._snapshot
        folding = list(self._frozen)
        # pending_dead holds kills landing AFTER this capture; entries of
        # an earlier (failed) build are stale and could kill a gid
        # re-appended by an update since
        self._pending_dead.clear()
        new_rows, new_gids = self._live_concat_locked(snap, folding)
        new_rows = np.ascontiguousarray(new_rows)
        if new_rows.shape[0] == 0:
            # an empty catalogue cannot be indexed: one dead guard row
            new_rows = np.zeros((1, self.rank), np.float32)
            new_gids = np.full((1,), -1, np.int64)
        version = snap.version + 1

        def build():
            ok = False
            t_build = time.perf_counter()
            try:
                faults.fire(FAULT_STALL)      # test seam: slow/stuck build
                faults.fire(FAULT_BUILD)      # test seam: failing build
                ctx = EngineContext(new_rows, version=version,
                                    **self._ctx_kwargs)
                new_snap = Snapshot(new_rows, new_gids, version, ctx)
                if new_gids[0] < 0:
                    new_snap.kill_rows([0])   # the guard row is dead
                faults.fire(FAULT_WARM)       # test seam: readiness failure
                own_compiles = self._ready(ctx, snap.ctx,
                                           new_snap.num_rows)
                with self._lock:
                    pend = [new_snap.gid_to_row[g]
                            for g in self._pending_dead
                            if g in new_snap.gid_to_row]
                    if pend:
                        new_snap.kill_rows(pend)
                    self._pending_dead.clear()
                    self._snapshot = new_snap
                    self._frozen = [s for s in self._frozen
                                    if s not in folding]
                    self._bump_epoch_locked("swap")
                    self.stats.n_compactions += 1
                    dt = time.perf_counter() - t_build
                    self.stats.last_compaction_s = dt
                    self.stats.compaction_s_total += dt
                    self.stats.engine_compiles_total += own_compiles
                    # a successful swap clears ALL stale failure state
                    self.last_build_error = None
                    self._consec_build_failures = 0
                    self._retry_not_before = 0.0
                    self._last_backoff_s = 0.0
                    obs.on_compaction(
                        "success", version=version, epoch=self._epoch,
                        duration_s=dt, engine_compiles=own_compiles,
                        headroom_compiles=0,
                        num_live=int(new_snap.num_rows - new_snap.n_dead))
                self._notify_invalidation()
            except Exception as exc:
                # the sealed segments stay queryable and refold later.
                # Recorded, never raised: a synchronous build runs in the
                # middle of a mutation batch, and raising there would
                # lose the batch's appends. compact(wait=True) surfaces it.
                with self._lock:
                    backoff = self._record_build_failure_locked(exc,
                                                                version)
                    if (self.auto_retry and self.compact_async
                            and self._consec_build_failures
                            <= self.build_retry_limit
                            and self._retry_timer is None):
                        tmr = threading.Timer(backoff, self._retry_build)
                        tmr.daemon = True
                        self._retry_timer = tmr
                        tmr.start()
                        obs.on_compaction(
                            "retry_scheduled", version_attempted=version,
                            backoff_s=backoff)
            else:
                ok = True
            finally:
                with self._lock:
                    self._build_started_at = None
                    self._watchdog_flagged = False
                    if self._build_thread is threading.current_thread():
                        self._build_thread = None
                    if ok and self.compact_async and self._frozen:
                        # segments sealed during this build: fold them now
                        # (spawned under the lock hold that cleared the
                        # slot, so flush() never sees an empty slot)
                        self._compact_locked()

        if self._consec_build_failures:
            self.stats.n_build_retries += 1     # attempt after >=1 failure
            obs.on_compaction(
                "retry", version_from=snap.version, version_to=version,
                consecutive_failures=self._consec_build_failures)
        self._build_started_at = time.monotonic()
        self._watchdog_flagged = False
        obs.on_compaction(
            "start", version_from=snap.version, version_to=version,
            epoch=self._epoch, chain_len=len(folding),
            n_rows=int(new_rows.shape[0]),
            sync=bool(not self.compact_async or force_sync))
        if self.compact_async and not force_sync:
            t = threading.Thread(target=build, name="segcat-compact",
                                 daemon=True)
            self._build_thread = t
            t.start()
        else:
            build()           # under the RLock; the swap re-enters it

    def compact(self, wait: bool = True) -> None:
        """Force a compaction now. ``wait=True`` loops until the chain is
        fully folded and raises when a build fails instead of spinning."""
        first = True
        while True:
            with self._lock:
                if not first and not self._frozen:
                    return
                fails_before = (self.stats.n_failed_compactions
                                + self.stats.n_failed_l1_folds)
                # force=True: an explicit compact() outranks the backoff
                self._compact_locked(force=True)
                t = self._build_thread
                first = False
            if not wait:
                return
            if t is not None:
                t.join()
            with self._lock:
                if not self._frozen:
                    return
                if (self.stats.n_failed_compactions
                        + self.stats.n_failed_l1_folds) > fails_before:
                    raise RuntimeError(
                        "compaction build failed; sealed segments remain "
                        "queryable and will be refolded"
                    ) from self.last_build_error

    def flush(self) -> None:
        """Block until every in-flight background build (and any refold
        it started) has swapped in. Passive about failures: the recorded
        error is in :attr:`last_build_error`."""
        while True:
            with self._lock:
                t = self._build_thread
            if t is None:
                return
            t.join()

    # -- query ---------------------------------------------------------------

    def query(self, engine: Engine, U, k: int,
              budget: Optional[int] = None,
              bcfg: Optional[tuple] = None
              ) -> Tuple[TopKResult, QueryInfo]:
        """Exact top-``k`` over every LIVE item, through ``engine``.

        Returns ``(result, info)``: ``result.indices`` are GLOBAL ids,
        ``result.n_scored`` adds the live delta slots scored to the
        authoritative base run's count, ``result.depth`` is the base
        engine's, and ``info`` is the segmented accounting. ``budget``
        caps the base engine's scan; the delta is always fully scored, so
        ``result.upper`` stays a valid certificate bound. ``bcfg`` is the
        batch's ``engine.batch_config``, when the caller has it.

        The batch runs against ONE state captured under the lock
        (snapshot, dead mask, delta views, the L1 tier): later mutations
        are not visible to it. The base ids resolve to (tombstone, gid) on
        the device; the escalation test reads one boolean per rung.
        """
        with self._lock:
            snap = self._snapshot
            segs = [s for s in self._segments() if s.count > 0]
            views = tuple(s.device_view() for s in segs)
            l1 = self._l1_stack_locked()      # None: no L1 tier / empty
            n_delta_live = (sum(s.n_live for s in segs)
                            + self._l1_live_locked())
            n_dead = snap.n_dead
            dead_dev, gids_dev = snap.dead_dev, snap.gids_dev
        k = int(k)
        if not views and l1 is None and n_dead == 0 and snap.identity:
            # never-mutated fast path: exactly the static server's
            res = engine.run(snap.ctx, U, k, budget=budget, bcfg=bcfg)
            return res, QueryInfo(0, min(k, snap.num_rows), 0,
                                  snap.version)
        U_dev = torch.atleast_2d(torch.as_tensor(
            U, dtype=torch.float32, device=snap.ctx.device))
        b = U_dev.shape[0]
        U_dev = pad_to_bucket(U_dev).contiguous()
        mb = snap.num_rows

        def run_at(kb):
            res = engine.run(snap.ctx, U_dev, kb, budget=budget, bcfg=bcfg)
            idx = res.indices.long()
            real = idx >= 0
            safe = torch.clamp(idx, 0, max(mb - 1, 0))
            tomb = real & dead_dev[safe]
            bg = torch.where(real, gids_dev[safe], -1)
            vals, gids, dropped = _segmented_tail(
                res.values, tomb, bg, U_dev, views, l1, k=k, kb=kb)
            return res, vals, gids, dropped

        # tombstone-adaptive base fetch: plain k with no dead rows, the
        # k + reserve rung the moment tombstones exist
        kb = min(mb, k if n_dead == 0 else k + self.overfetch_reserve)
        res, vals, gids, dropped = run_at(kb)
        retried = False
        # escalation ladder: a rung is exact for every query whose dropped
        # count fits the margin (dropped <= kb - k); a full-base fetch is
        # exact unconditionally, so the ladder ends
        while (n_dead and kb < mb
               and bool((dropped > kb - k).any())):
            step = max(kb - k, self.overfetch_reserve // ESCALATION_STEP, 1)
            kb = min(mb, k + ESCALATION_STEP * step)
            res, vals, gids, dropped = run_at(kb)
            retried = True
        n_scored = res.n_scored + n_delta_live
        # the base engine's bound covers every un-enumerated base item and
        # the delta is fully scored: a valid bound for the merged result
        upper = None if res.upper is None else res.upper[:b]
        out = TopKResult(vals[:b], gids[:b], n_scored[:b], res.depth[:b],
                         upper=upper)
        return out, QueryInfo(int(n_delta_live), kb, len(views),
                              snap.version, retried)

    # -- warmup --------------------------------------------------------------

    def warm(self, k: int, batch_sizes=(1, 64), engines=None,
             budgets=None) -> "SegmentedCatalogue":
        """Ready the snapshot for tombstoned traffic: with ``engines``,
        run them at the over-fetched ``k + overfetch_reserve`` (the fetch
        of any tombstoned snapshot) so their state at that ``k`` is
        built. The segmented tail is plain PyTorch and needs no warming:
        the port has no per-shape tail cache, so the reference's
        ``_warm_l1_variants`` (the L1 tier's tail shapes) has no
        counterpart."""
        snap = self._snapshot
        kb_esc = min(snap.num_rows, int(k) + self.overfetch_reserve)
        if engines and kb_esc > min(snap.num_rows, int(k)):
            snap.ctx.warmup(kb_esc, batch_sizes=batch_sizes,
                            engines=engines, budgets=budgets)
        return self

    def set_warm_spec(self, k: int, batch_sizes, engines=None,
                      budgets=None) -> None:
        """Remember what to ready on each compacted snapshot before its
        swap (:meth:`_ready`), so the first query after a swap finds the
        engines' state built."""
        self._warm_spec = (int(k), tuple(batch_sizes), engines,
                           None if budgets is None
                           else tuple(int(b) for b in budgets))
