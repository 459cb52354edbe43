"""Sharded multi-level streaming catalogue: the LSM ladder (DESIGN.md §15).

The port of the reference's ``core/lsm.py``.
:class:`repro_torch.core.segments.SegmentedCatalogue` is single-level:
every compaction folds the whole delta chain into a fresh base snapshot,
and at LSHTC-like sizes that full rebuild (mostly the host index sort) is
the whole compaction cost, paid every ``delta_capacity`` mutations. This
module adds the two LSM rungs that amortise it:

* **L1 tier** — per-shard append runs (plain
  :class:`~repro_torch.core.segments.DeltaSegment` instances on the
  catalogue's device, one per shard). A sealed L0 delta segment FOLDS
  into the tier by dealing its live rows round-robin across the shard
  runs: host row copies under the catalogue lock, no index build, no
  layout build, no engine work.
* **Promotion** — only when the tier cannot absorb the next fold (or
  base tombstones cross the compaction threshold) do the runs seal and
  join the frozen chain, and ONE ordinary base rebuild (the inherited
  builder, with its readiness and recovery machinery) flattens base + L1
  + L0 into a fresh snapshot. With the default sizing
  (``DEFAULT_L1_CAPACITY_FACTOR * delta_capacity`` rows a shard) a ladder
  of S shards runs about ``4 S`` folds per rebuild.

**Exactness** is inherited: the ladder only moves rows between tiers that
are all FULLY dense-scored by every query. The L1 tier is scored by one
``[B, R] x [S, C, R]`` einsum and folds through
:func:`repro_torch.core.sharded.shard_fold_topk` before the L0 chain and
the active delta (:func:`repro_torch.core.segments._segmented_tail`), in
plain PyTorch on the catalogue's device, as the reference computes it
outside any Pallas kernel.

**The stacked view** is built from the runs' RAW storage at full
per-shard capacity — ``(rows [S, C, R], gids [S, C], live [S, C])`` —
uploaded once per fold, kill or promotion and cached, never once per
query. The port has no per-shape tail cache, so the reference's
``_warm_l1_variants`` has no counterpart. A fold changes no visible
content, so ``cache_token`` does not move (no epoch bump).

**Recovery** mirrors the build machinery (DESIGN.md §12): the
``compaction.fold_l1`` seam fires before any run is touched, so an
injected fold failure leaves the sealed chain intact and queryable; fold
failures are recorded (never raised into a mutation batch), gated by
their own exponential backoff and ``build_retry_limit`` streak, and
surfaced by ``compact(wait=True)``. The ``compaction.promote`` seam fires
at the overflow decision, before the rebuild launches: an injected
promotion failure is recorded as a build failure and the tier and chain
keep serving.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import faults
from repro_torch.core.engines import batch_bucket
from repro_torch.core.layout import round_robin_shares
from repro_torch.core.segments import DeltaSegment, SegmentedCatalogue

__all__ = ["ShardedLsmCatalogue", "DEFAULT_L1_CAPACITY_FACTOR"]

#: Default per-shard L1 run capacity, as a multiple of ``delta_capacity``:
#: an S-shard ladder runs about 4·S folds per full rebuild.
DEFAULT_L1_CAPACITY_FACTOR = 4


class ShardedLsmCatalogue(SegmentedCatalogue):
    """Per-shard LSM compaction ladder over the segmented catalogue.

    Everything the base class guarantees (exactness at any mutation
    rate, no kernel library load per mutation, crash-safe build recovery,
    the ``(version, epoch)`` cache token) holds unchanged; this subclass
    only changes WHAT a compaction trigger does: fold the sealed L0
    chain into the per-shard L1 tier when it fits, promote the tier
    into a full base rebuild when it does not.

    Args:
      targets: initial ``[M, R]`` catalogue (global ids ``0..M-1``).
      n_shards: L1 shard-run count (any value >= 1: the tier merge is
        mesh-free).
      l1_capacity: per-shard run capacity in rows (rounded up to a
        power of two). ``None`` uses
        ``DEFAULT_L1_CAPACITY_FACTOR * delta_capacity``.
      **kwargs: forwarded to :class:`SegmentedCatalogue`.
    """

    def __init__(self, targets, *, n_shards: int = 8,
                 l1_capacity: Optional[int] = None, **kwargs):
        super().__init__(targets, **kwargs)
        self._n_shards = max(int(n_shards), 1)
        if l1_capacity is None:
            l1_capacity = DEFAULT_L1_CAPACITY_FACTOR * self.delta_capacity
        self._l1_run_capacity = batch_bucket(max(int(l1_capacity), 1))
        with self._lock:
            self._l1: List[DeltaSegment] = self._new_l1()
            self._l1_cursor = 0               # round-robin deal position
            self._l1_dev = None               # cached stacked device view
            # L1 runs parked in the frozen chain by an in-flight
            # promotion (excluded from chain-cap pressure; see
            # _chain_pressure_locked)
            self._promoted_runs: List[DeltaSegment] = []
            # fold-failure recovery state, mirroring the build machinery
            self._consec_fold_failures = 0
            self._fold_not_before = 0.0       # monotonic deadline
            self._last_fold_backoff_s = 0.0
            self._promoting = False           # re-entry guard
            self.last_fold_error: Optional[BaseException] = None

    def _new_l1(self) -> List[DeltaSegment]:
        """One empty run per shard, on the catalogue's device."""
        return [DeltaSegment(self._l1_run_capacity, self.rank, self.device)
                for _ in range(self._n_shards)]

    # -- introspection -------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self._n_shards

    @property
    def l1_run_capacity(self) -> int:
        return self._l1_run_capacity

    @property
    def l1_rows(self) -> int:
        with self._lock:
            return self._l1_live_locked()

    @property
    def consecutive_fold_failures(self) -> int:
        with self._lock:
            return self._consec_fold_failures

    @property
    def fold_backoff_s(self) -> float:
        with self._lock:
            return (self._last_fold_backoff_s
                    if self._consec_fold_failures else 0.0)

    @property
    def n_tombstones(self) -> int:
        with self._lock:
            return self._snapshot.n_dead + sum(
                int(np.sum(seg.dead[:seg.count]))
                for seg in (*self._l1, *self._segments()))

    @property
    def num_live(self) -> int:
        with self._lock:
            return (self._snapshot.num_rows - self._snapshot.n_dead
                    + sum(seg.n_live
                          for seg in (*self._l1, *self._segments())))

    @property
    def pristine(self) -> bool:
        with self._lock:                      # RLock: nested read is fine
            return (all(run.count == 0 for run in self._l1)
                    and SegmentedCatalogue.pristine.fget(self))

    def as_dense(self):
        with self._lock:
            # ladder age order: base, L1 (older), frozen L0, active delta
            return self._live_concat_locked(
                self._snapshot, [*self._l1, *self._segments()])

    def _chain_pressure_locked(self) -> int:
        self._promoted_runs = [r for r in self._promoted_runs
                               if r in self._frozen]
        return len(self._frozen) - len(self._promoted_runs)

    # -- locate/kill across the extra tier -----------------------------------

    def _locate(self, gid: int):
        if gid in self._delta._pos:
            return "delta", self._delta
        for frozen in self._frozen:
            if gid in frozen._pos:
                return "frozen", frozen
        for run in self._l1:
            if gid in run._pos:
                return "l1", run
        row = self._snapshot.gid_to_row.get(gid)
        if row is not None and not self._snapshot.dead_np[row]:
            return "base", row
        raise KeyError(f"gid {gid} is not a live catalogue item")

    def _kill_located(self, located) -> None:
        # "l1" kills ride the base else-branch (seg.kill); runs in the
        # tier are never captured by an in-flight build (promotion moves
        # them into the frozen chain first, where kills take the
        # pending-dead path), so no extra bookkeeping — just drop the
        # cached stacked view.
        super()._kill_located(located)
        if any(where == "l1" for _, where, _ in located):
            self._l1_dev = None

    # -- L1 tier presentation (the hooks the base query path calls) ---------

    def _l1_live_locked(self) -> int:
        return sum(run.n_live for run in self._l1)

    def _l1_stack_locked(self):
        if all(run.count == 0 for run in self._l1):
            return None
        if self._l1_dev is None:
            cap = self._l1_run_capacity
            live = np.zeros((self._n_shards, cap), bool)
            for s, run in enumerate(self._l1):
                live[s, :run.count] = ~run.dead[:run.count]
            # RAW storage at full capacity, not device_view(): one
            # (n_shards, capacity) operand whatever the occupancy. Uploaded
            # once per fold, kill or promote (a fresh stack each time, so
            # a query in flight keeps the one it captured)
            dev = self.device
            self._l1_dev = (
                torch.tensor(np.stack([run.rows for run in self._l1]),
                             device=dev),
                torch.tensor(np.stack([run.gids for run in self._l1]
                                      ).astype(np.int32), device=dev),
                torch.tensor(live, device=dev))
        return self._l1_dev

    # -- the ladder decision -------------------------------------------------

    def _compact_locked(self, force: bool = False,
                        force_sync: bool = False) -> None:
        if self._promoting:
            # re-entry guard: while the promotion path below is driving
            # the inherited builder, any nested virtual dispatch must
            # mean BASE semantics, not a second ladder decision
            return super()._compact_locked(force, force_sync)
        snap = self._snapshot
        if (self._delta.count == 0 and not self._frozen
                and snap.n_dead == 0):
            return                            # nothing to fold
        # seal the active delta into the L0 chain (same clause as base)
        if self._delta.count > 0 or not self._frozen:
            sealed = self._delta
            sealed.seal()
            self._frozen.append(sealed)
            self._delta = self._new_delta()
            self.stats.max_l0_chain = max(self.stats.max_l0_chain,
                                          len(self._frozen))
        if self._build_thread is not None:
            return                            # in-flight build; chain waits
        # the ladder decision: fold when the tier can absorb the chain,
        # promote when it cannot (or base tombstones crossed the
        # compaction threshold — only a rebuild reclaims those)
        thresh = min(float(self.max_tombstones),
                     self.tombstone_compact_fraction
                     * max(snap.num_rows, 1))
        n_fold = sum(s.n_live for s in self._frozen)
        shares = round_robin_shares(n_fold, self._n_shards,
                                    self._l1_cursor)
        fits = all(int(shares[s]) <= run.capacity - run.count
                   for s, run in enumerate(self._l1))
        if (snap.n_dead and snap.n_dead >= thresh) or not fits:
            self._promote_locked(force_sync)
        else:
            self._fold_locked(force)

    def _fold_locked(self, force: bool) -> None:
        """Deal the sealed chain's live rows into the per-shard L1 runs.

        Synchronous under the lock — the fold is a few thousand host row
        copies, ~1000x cheaper than the rebuild it replaces. NEVER
        raises: a failure (the ``compaction.fold_l1`` seam, which fires
        before any slab is touched) is recorded exactly like a build
        failure — the chain stays sealed + queryable, retries are gated
        by an exponential backoff and the ``build_retry_limit`` streak,
        and ``compact(wait=True)`` surfaces the recorded error. The
        cache token does NOT move: a fold relocates rows without
        changing what queries see, so cached results remain exact.
        """
        if not force and self._retry_gated(self._consec_fold_failures,
                                           self._fold_not_before):
            return
        folding = list(self._frozen)
        if self._consec_fold_failures:
            self.stats.n_l1_fold_retries += 1
        t0 = time.perf_counter()
        try:
            faults.fire(faults.FAULT_FOLD_L1)
            cur, moved = self._l1_cursor, 0
            for seg in folding:
                if not seg.count:
                    continue
                rows, gids = seg.live_rows()
                for row, gid in zip(rows, gids):
                    run = self._l1[(cur + moved) % self._n_shards]
                    run.append(row, int(gid))
                    moved += 1
            self._l1_cursor = (cur + moved) % self._n_shards
            self._frozen = [s for s in self._frozen if s not in folding]
            self._l1_dev = None
            dt = time.perf_counter() - t0
            self.stats.n_l1_folds += 1
            self.stats.l1_fold_s_total += dt
            self.last_fold_error = None
            self._consec_fold_failures = 0
            self._fold_not_before = 0.0
            self._last_fold_backoff_s = 0.0
            # same join keys as compaction.success (version, epoch): the
            # journal can join a traced request's device span to the
            # exact per-shard state it scanned across the fold
            obs.on_compaction(
                "fold_l1", version=self._snapshot.version,
                epoch=self._epoch, chain_len=len(folding),
                rows_folded=int(moved),
                l1_rows=int(self._l1_live_locked()), duration_s=dt)
        except Exception as exc:
            self.last_fold_error = exc
            self.stats.n_failed_l1_folds += 1
            self._consec_fold_failures += 1
            backoff = self._backoff_after(self._consec_fold_failures)
            self._last_fold_backoff_s = backoff
            self._fold_not_before = time.monotonic() + backoff
            obs.on_compaction(
                "fold_fail", version=self._snapshot.version,
                epoch=self._epoch, error=repr(exc),
                consecutive_failures=self._consec_fold_failures,
                backoff_s=backoff)

    def _promote_locked(self, force_sync: bool) -> None:
        """Seal the L1 tier into the chain and run ONE full base rebuild.

        The inherited builder does all the heavy lifting (readiness
        warm, pending-dead replay, failure backoff, async recovery);
        this method only decides and stages. The ``compaction.promote``
        seam fires BEFORE anything moves — an injected failure is
        recorded as a build failure and the tier keeps serving as is.
        """
        # the build-failure gate, checked BEFORE disturbing the tier so
        # a gated promote leaves the runs in place (no churn through the
        # frozen chain); the super() call below then forces past its own
        # identical gate — the decision is already made here
        if self._retry_gated(self._consec_build_failures,
                             self._retry_not_before):
            return
        try:
            faults.fire(faults.FAULT_PROMOTE)
        except Exception as exc:
            self._record_build_failure_locked(exc,
                                              self._snapshot.version + 1)
            return
        promoted = []
        for run in self._l1:
            if run.count:
                run.seal()                    # full-capacity device view
                self._frozen.append(run)
                promoted.append(run)
        self._promoted_runs = promoted
        self._l1 = self._new_l1()
        self._l1_cursor = 0
        self._l1_dev = None
        obs.on_compaction(
            "promote", version=self._snapshot.version, epoch=self._epoch,
            chain_len=len(self._frozen),
            rows_promoted=sum(r.n_live for r in promoted))
        self._promoting = True
        try:
            # force=True: the gate was already checked above, and the
            # runs are staged in the chain — the build MUST launch (a
            # bail here would leave them to churn back through a fold)
            super()._compact_locked(force=True, force_sync=force_sync)
        finally:
            self._promoting = False

    def promote(self, wait: bool = True) -> None:
        """Force a full promotion now: flatten L1 + L0 + delta into a
        fresh base snapshot (the ladder's equivalent of the base
        class's unconditional ``compact``). ``wait=True`` surfaces a
        recorded build failure as an exception."""
        self.flush()                          # let an in-flight build land
        with self._lock:
            # stage EVERYTHING: seal the active delta if it has rows...
            if self._delta.count > 0:
                sealed = self._delta
                sealed.seal()
                self._frozen.append(sealed)
                self._delta = self._new_delta()
                self.stats.max_l0_chain = max(self.stats.max_l0_chain,
                                              len(self._frozen))
            if self._build_thread is None:
                fails_before = self.stats.n_failed_compactions
                self._promote_locked(force_sync=False)
            else:
                fails_before = None           # ride the in-flight build
        if not wait:
            return
        self.flush()
        with self._lock:
            if (fails_before is not None
                    and self.stats.n_failed_compactions > fails_before):
                raise RuntimeError(
                    "promotion build failed; the L1 tier and sealed "
                    "chain remain queryable"
                ) from self.last_build_error
