"""Declared schemas for dict-shaped stats surfaces.

``TopKServer.mutation_stats`` grew one key per PR and ended up mixing
ints, floats, numpy scalars, bools-as-ints and derived ratios with no
declared types — harness code downstream (benchmarks, CI gates,
dashboards) had to guess. The schema now lives HERE, once:
:data:`MUTATION_STATS_SCHEMA` names every key, its type and its
meaning, and :func:`build_mutation_stats` is the single constructor —
it checks the produced dict carries EXACTLY the declared keys and
coerces each value to its declared Python type (so a numpy ``int64``
or a ``bool`` can never leak into a JSON artifact again). Adding a key
without documenting it is now a hard error, not a drift.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["StatField", "MUTATION_STATS_SCHEMA", "build_mutation_stats"]


@dataclasses.dataclass(frozen=True)
class StatField:
    """One declared key: its coerced Python type and its meaning."""

    type: type
    doc: str


#: The one place the ``mutation_stats`` shape is defined. Keys are
#: grouped the way the serving docs discuss them; every value is
#: coerced to ``type`` by :func:`build_mutation_stats`.
MUTATION_STATS_SCHEMA: Dict[str, StatField] = {
    # -- mutation traffic ---------------------------------------------------
    "n_inserts": StatField(int, "rows streamed in via add_targets"),
    "n_deletes": StatField(int, "rows tombstoned via delete_targets"),
    "n_updates": StatField(int, "rows replaced via update_targets"),
    # -- delta / tombstone occupancy ---------------------------------------
    "delta_occupancy": StatField(
        int, "rows currently in the active delta + sealed L0 chain"),
    "max_delta_occupancy": StatField(
        int, "high-water mark of delta occupancy since boot"),
    "n_tombstones": StatField(
        int, "dead rows currently visible (base + segments)"),
    "num_live": StatField(int, "live rows currently visible"),
    "snapshot_version": StatField(
        int, "current base snapshot version (bumps on every swap; one "
             "half of the cache token / span join key)"),
    # -- compaction ---------------------------------------------------------
    "n_compactions": StatField(
        int, "successful compaction swaps since boot"),
    "n_failed_compactions": StatField(
        int, "compaction builds that raised (chain retained, no loss)"),
    "compaction_s_total": StatField(
        float, "wall-clock seconds spent in successful builds"),
    "last_compaction_s": StatField(
        float, "wall-clock seconds of the most recent successful build"),
    "engine_compiles_total": StatField(
        int, "engine compiles charged to compaction builds (kernel "
             "library loads in the port; 0 for warmed compactions — the "
             "DESIGN.md §10 contract)"),
    "engine_compiles_per_compaction": StatField(
        float, "engine_compiles_total / max(n_compactions, 1) — the "
               "compile-free-compaction gate reads this"),
    "headroom_compiles_total": StatField(
        int, "traces spent pre-warming the NEXT M-bucket (an investment "
             "for a future crossing, separated from per-build cost)"),
    # -- recovery machinery (DESIGN.md §12) ---------------------------------
    "n_build_retries": StatField(
        int, "build attempts made after >= 1 consecutive failure"),
    "n_forced_sync_compactions": StatField(
        int, "chain-cap back-pressure builds run inline in the mutating "
             "caller"),
    "n_stuck_builds": StatField(
        int, "watchdog detections of an over-deadline in-flight build"),
    "max_l0_chain": StatField(
        int, "longest sealed-segment chain ever observed"),
    "l0_chain_len": StatField(
        int, "sealed segments currently awaiting compaction"),
    "consecutive_build_failures": StatField(
        int, "current failure streak (0 on a healthy server)"),
    "current_backoff_s": StatField(
        float, "backoff the next automatic retry is waiting out"),
    "retry_pending": StatField(
        int, "1 while an automatic post-failure retry timer is armed"),
    # -- LSM ladder (DESIGN.md §15) -----------------------------------------
    # all zero on the single-level catalogue (the base-class hooks
    # return neutral values), so one schema covers both catalogues
    "n_shards": StatField(
        int, "L1 shard-run count (0: single-level, no L1 tier)"),
    "l1_rows": StatField(
        int, "live rows currently resident in the per-shard L1 tier"),
    "n_l1_folds": StatField(
        int, "successful L0 -> L1 folds (the cheap moves that replace "
             "most full base rebuilds)"),
    "n_failed_l1_folds": StatField(
        int, "folds that raised (chain retained + queryable, no loss)"),
    "n_l1_fold_retries": StatField(
        int, "fold attempts made after >= 1 consecutive fold failure"),
    "l1_fold_s_total": StatField(
        float, "wall-clock seconds spent in successful folds"),
    "consecutive_fold_failures": StatField(
        int, "current L0 -> L1 fold failure streak (0 when healthy)"),
    "fold_backoff_s": StatField(
        float, "backoff the next ordinary fold retry is waiting out"),
}


def build_mutation_stats(values: Dict[str, object]) -> Dict[str, object]:
    """Validate ``values`` against :data:`MUTATION_STATS_SCHEMA` and
    coerce every entry to its declared type. Raises ``KeyError`` when a
    key is missing or undeclared — the schema and the producer can
    never silently diverge."""
    missing = MUTATION_STATS_SCHEMA.keys() - values.keys()
    extra = values.keys() - MUTATION_STATS_SCHEMA.keys()
    if missing or extra:
        raise KeyError(
            f"mutation_stats schema mismatch: missing={sorted(missing)} "
            f"undeclared={sorted(extra)} — update "
            f"repro_torch.obs.schema.MUTATION_STATS_SCHEMA")
    return {k: MUTATION_STATS_SCHEMA[k].type(values[k])
            for k in MUTATION_STATS_SCHEMA}
