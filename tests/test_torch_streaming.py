"""The seeded schedule sweep of ``tests/test_streaming_properties.py``
on the port's streaming catalogues.

Interleaved insert / update / delete / query / compact / flush / fault
schedules (synchronous and background builds, injected build and fold
failures) run against the port's :class:`SegmentedCatalogue` (shard
count 0) or :class:`ShardedLsmCatalogue` (``l1_capacity=8``) on the CPU,
and EVERY query is checked against the reference's fresh-rebuild oracle:
an independent ``{gid: row}`` shadow dict scored in float64. Each seed
draws its schedule, shard count included, exactly as the reference's
``_run_one_schedule`` does, so seed ``s`` here replays the reference's
schedule ``s``, ``fault_fold`` included. ``STREAMING_SCHEDULES`` sets the
sweep's length (default 200, the reference's acceptance sweep). The
synchronous schedules among the first 30 also replay through both
packages in lockstep (:class:`_torch_streaming_pair.Pair`): values, ids,
counts and ``QueryInfo`` equal the reference's at every query.
"""

import os

import numpy as np
import pytest

from repro_torch.core import (SegmentedCatalogue, ShardedLsmCatalogue,
                              faults, get_engine)

from _torch_streaming_pair import Pair, arm_both, disarm_all_both

R = 6
K = 4

BOUNDARY_M = [7, 8, 9, 15, 16, 17, 31, 32, 33]
SHARD_COUNTS = [0, 1, 4, 8]          # 0 = single-level SegmentedCatalogue

_KINDS = ["insert", "delete", "update", "query", "compact", "flush",
          "fault_build", "fault_fold"]
_WEIGHTS = [0.30, 0.12, 0.12, 0.18, 0.10, 0.06, 0.06, 0.06]


@pytest.fixture(autouse=True)
def _clean_faults():
    disarm_all_both()
    yield
    disarm_all_both()


def _rows(rng, n, positive):
    r = rng.standard_normal((n, R)).astype(np.float32)
    return np.abs(r) if positive else r


def _make(base, n_shards, compact_async, pair=False):
    kw = dict(delta_capacity=4, block_size=8, compact_async=compact_async,
              build_backoff_s=0.0, max_l0_segments=8)
    if n_shards:
        kw.update(n_shards=n_shards, l1_capacity=8)
    if pair:
        return Pair(base, **kw)
    if n_shards:
        return ShardedLsmCatalogue(base, device="cpu", **kw)
    return SegmentedCatalogue(base, device="cpu", **kw)


def _check_query(cat, shadow, U, k=K, engine="norm"):
    """One query vs the fresh-rebuild oracle: exact values, live and
    consistent gids, correct padding."""
    if isinstance(cat, Pair):
        res, _ = cat.query(engine, U, k)
    else:
        res, _ = cat.query(get_engine(engine), U, k)
    vals = res.values.numpy()
    idx = res.indices.numpy()
    assert cat.num_live == len(shadow)
    kk = min(k, len(shadow))
    if kk == 0:
        assert np.all(idx == -1)
        return
    gids = np.fromiter(shadow.keys(), np.int64, len(shadow))
    rows = np.stack([shadow[int(g)] for g in gids]).astype(np.float64)
    s = np.atleast_2d(U).astype(np.float64) @ rows.T
    want = -np.sort(-s, axis=1)[:, :kk]
    np.testing.assert_allclose(vals[:, :kk], want, atol=1e-4)
    by_gid = {int(g): rows[i] for i, g in enumerate(gids)}
    for b in range(idx.shape[0]):
        for j in range(kk):
            g = int(idx[b, j])
            assert g in by_gid, (b, j, g)
            np.testing.assert_allclose(
                vals[b, j],
                float(np.atleast_2d(U).astype(np.float64)[b] @ by_gid[g]),
                atol=1e-4)
    assert np.all(idx[:, kk:] == -1)


def _arm(cat, point):
    if isinstance(cat, Pair):
        arm_both(point, error=RuntimeError, times=1)
    else:
        faults.arm(point, error=RuntimeError, times=1)


def _replay(cat, shadow, ops, rng, positive):
    """Apply one schedule to (catalogue, shadow) in lockstep, checking
    exactness at every query op and once more at the end."""
    for op in ops:
        kind = op[0]
        if kind == "insert":
            rows = _rows(rng, op[1], positive)
            for g, row in zip(cat.add_targets(rows), rows):
                shadow[int(g)] = row
        elif kind == "delete":
            if shadow:
                victim = sorted(shadow)[op[1] % len(shadow)]
                cat.delete_targets([victim])
                del shadow[victim]
        elif kind == "update":
            if shadow:
                victim = sorted(shadow)[op[1] % len(shadow)]
                row = _rows(rng, 1, positive)
                cat.update_targets([victim], row)
                shadow[victim] = row[0]
        elif kind == "query":
            _check_query(cat, shadow, _rows(rng, op[1], positive))
        elif kind == "compact":
            try:
                cat.compact(wait=True)
            except RuntimeError:
                pass                     # injected failure: chain retained
        elif kind == "flush":
            cat.flush()
        elif kind == "fault_build":
            _arm(cat, "compaction.build")
        elif kind == "fault_fold":
            _arm(cat, "compaction.fold_l1")   # fires at a ladder's fold
    _check_query(cat, shadow, _rows(rng, 2, positive))
    if isinstance(cat, Pair):
        cat.check_state()


def _draw_schedule(rng):
    ops = []
    for _ in range(int(rng.integers(1, 25))):
        kind = rng.choice(_KINDS, p=_WEIGHTS)
        if kind == "insert":
            ops.append(("insert", int(rng.integers(1, 7))))
        elif kind in ("delete", "update"):
            ops.append((kind, int(rng.integers(0, 64))))
        elif kind == "query":
            ops.append(("query", int(rng.integers(1, 3))))
        else:
            ops.append((kind,))
    return ops


def _draw(seed):
    """The reference's draw for ``seed``: (n_shards, m0, positive,
    compact_async, ops, the generator positioned where its replay
    starts)."""
    rng = np.random.default_rng(seed)
    n_shards = SHARD_COUNTS[int(rng.integers(len(SHARD_COUNTS)))]
    m0 = BOUNDARY_M[int(rng.integers(len(BOUNDARY_M)))]
    positive = bool(rng.integers(2))
    compact_async = bool(rng.integers(2))
    ops = _draw_schedule(rng)
    return n_shards, m0, positive, compact_async, ops, rng


def _run_one_schedule(seed, pair=False):
    n_shards, m0, positive, compact_async, ops, rng = _draw(seed)
    base = _rows(rng, m0, positive)
    cat = _make(base, n_shards, compact_async, pair)
    shadow = {i: base[i] for i in range(m0)}
    try:
        _replay(cat, shadow, ops, rng, positive)
    finally:
        disarm_all_both()
        cat.flush()


def test_seeded_schedule_sweep():
    """STREAMING_SCHEDULES schedules against the float64 oracle, each
    reproducible from the printed seed via ``_run_one_schedule(seed)``."""
    n = int(os.environ.get("STREAMING_SCHEDULES", "200"))
    for seed in range(n):
        try:
            _run_one_schedule(seed)
        except Exception:
            print(f"streaming schedule FAILED: "
                  f"_run_one_schedule({seed}) reproduces it")
            raise


def test_synchronous_schedules_match_the_reference():
    """The sweep's synchronous schedules through both packages in
    lockstep: every query count-equal to the reference's, and the same
    visible contents and counters at the end."""
    seeds = [s for s in range(30) if not _draw(s)[3]]
    assert seeds and {_draw(s)[0] for s in seeds} == set(SHARD_COUNTS)
    for seed in seeds:
        try:
            _run_one_schedule(seed, pair=True)
        except Exception:
            print(f"streaming schedule FAILED: "
                  f"_run_one_schedule({seed}, pair=True) reproduces it")
            raise
