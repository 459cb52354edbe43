"""The port's streaming catalogue against the reference's, case for case
with ``tests/test_segments.py``.

Each case runs one seeded schedule through both packages in lockstep
(:class:`_torch_streaming_pair.Pair`): every query's values, ids,
``n_scored``, ``depth`` and ``QueryInfo`` must equal the reference's,
the visible contents and counters after it too, and the port's result
must equal a float64 rebuild oracle over the live rows, as the
reference's own tests demand of it. Then ``k = 300`` through
``topk_mips`` (past the CUDA kernel's shared-memory carry) and the
server's mutations."""

import time

import numpy as np
import pytest
import torch

import repro.core.segments as ref_seg_mod
import repro_torch.core.segments as seg_mod
from repro.core import SepLRModel as RefModel
from repro.core.segments import ESCALATION_STEP
from repro.serving.server import TopKServer as RefServer
from repro_torch import obs
from repro_torch.core import (EngineContext, SegmentedCatalogue, SepLRModel,
                              get_engine)
from repro_torch.serving.server import TopKServer

from _torch_streaming_pair import Pair, assert_same_result

R = 12
K = 5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _base(rng, m=400):
    return rng.standard_normal((m, R)).astype(np.float32)


def _oracle(cat, U, k):
    """Fresh-rebuild oracle: dense float64 scores over the live set."""
    rows, gids = cat.as_dense()
    U = np.atleast_2d(np.asarray(U, np.float32))
    s = U.astype(np.float64) @ rows.astype(np.float64).T
    order = np.argsort(-s, kind="stable", axis=1)[:, :k]
    return s[np.arange(U.shape[0])[:, None], order], gids[order]


def _rebuilt_engine_topk(cat, engine_name, U, k):
    """A FRESH port index + engine over the live set. (values, gids)."""
    rows, gids = cat.as_dense()
    ctx = EngineContext(rows, block_size=32, device="cpu")
    res = get_engine(engine_name).run(ctx, np.atleast_2d(U), k)
    idx = res.indices.numpy()
    return res.values.numpy(), np.where(idx >= 0, gids[idx], -1)


def assert_exact(cat, U, k=K, engine="norm", counts=True):
    """Both packages agree (``Pair.query``), and the port's result equals
    the rebuild oracle: values, padding, live ids scoring what they claim,
    id sets where the k-boundary is unambiguous."""
    res, info = cat.query(engine, U, k, counts=counts)
    vals = res.values.numpy()
    gids = res.indices.numpy()
    ov, og = _oracle(cat, U, k)
    n_live = cat.num_live
    kk = min(k, n_live)
    np.testing.assert_allclose(vals[:, :kk], ov[:, :kk], atol=1e-4)
    if kk < k:
        assert np.all(vals[:, kk:] == -np.inf)
        assert np.all(gids[:, kk:] == -1)
    rows, all_gids = cat.as_dense()
    by_gid = {int(g): rows[i] for i, g in enumerate(all_gids)}
    Ub = np.asarray(U, np.float32).reshape(-1, R)
    for b in range(vals.shape[0]):
        for j in range(kk):
            g = int(gids[b, j])
            assert g in by_gid, f"returned gid {g} is not live"
            np.testing.assert_allclose(float(Ub[b] @ by_gid[g]), vals[b, j],
                                       atol=1e-4)
        if n_live > kk and kk > 0 and ov[b, kk - 1] - _oracle(
                cat, Ub[b], kk + 1)[0][0, kk] > 1e-4:
            assert set(gids[b, :kk].tolist()) == set(og[b, :kk].tolist())
    return res, info


def test_pristine_matches_static_path():
    rng = _rng(0)
    cat = Pair(_base(rng), block_size=32)
    U = rng.standard_normal((4, R)).astype(np.float32)
    assert cat.pristine
    res, info = cat.query("bta", U, K)
    assert info.n_segments == 0 and info.delta_scored == 0
    ov, og = _oracle(cat, U, K)
    np.testing.assert_allclose(res.values.numpy(), ov, atol=1e-4)
    np.testing.assert_array_equal(res.indices.numpy(), og)
    # the fast path IS the engine's own run
    raw = get_engine("bta").run(cat.snapshot.ctx, U, K)
    assert_same_result(res, raw)


def test_tombstoned_row_in_base_topk_is_dropped():
    rng = _rng(1)
    cat = Pair(_base(rng), block_size=32)
    U = rng.standard_normal((3, R)).astype(np.float32)
    _, top_gids = _oracle(cat, U, 1)
    victims = sorted({int(g) for g in top_gids.ravel()})
    cat.delete_targets(victims)
    res, info = assert_exact(cat, U)
    assert not info.retried
    assert info.overfetch_k == min(cat.snapshot.num_rows,
                                   K + cat.overfetch_reserve)
    assert not (set(res.indices.numpy().ravel().tolist()) & set(victims))
    cat.check_state()


def test_update_replaces_in_place_and_twice():
    rng = _rng(2)
    cat = Pair(_base(rng), block_size=32)
    U = rng.standard_normal((2, R)).astype(np.float32)
    gid = 7
    big = (10.0 * U[0] / np.linalg.norm(U[0])).astype(np.float32)
    cat.update_targets([gid], [big])
    res, _ = assert_exact(cat, U)
    assert int(res.indices[0, 0]) == gid
    cat.update_targets([gid], [np.zeros(R, np.float32)])
    res, _ = assert_exact(cat, U)
    assert int(res.indices[0, 0]) != gid
    assert cat.num_live == 400
    cat.check_state()


def test_all_negative_queries_stay_exact():
    rng = _rng(3)
    cat = Pair(_base(rng), block_size=32)
    U = -np.abs(rng.standard_normal((3, R))).astype(np.float32)
    cat.add_targets(-np.abs(rng.standard_normal((5, R))).astype(np.float32))
    cat.delete_targets([0, 1])
    assert_exact(cat, U)
    cat.check_state()


def test_delta_overflow_forces_compaction_and_stays_exact():
    rng = _rng(4)
    cat = Pair(_base(rng, 200), delta_capacity=8, block_size=32)
    U = rng.standard_normal((2, R)).astype(np.float32)
    for i in range(30):
        cat.add_targets(rng.standard_normal((1, R)).astype(np.float32) * 2)
        if i % 7 == 0:
            assert_exact(cat, U)
    assert cat.stats.n_compactions >= 3
    assert cat.version == cat.stats.n_compactions
    assert cat.num_live == 230
    assert_exact(cat, U)
    assert cat.n_tombstones == 0
    assert cat.snapshot.ctx.version == cat.version
    cat.check_state()


def test_n_scored_extends_to_delta_and_depth_is_base():
    rng = _rng(5)
    cat = Pair(_base(rng), block_size=32)
    U = rng.standard_normal((2, R)).astype(np.float32)
    base_res, _ = cat.query("norm", U, K)
    cat.add_targets(rng.standard_normal((6, R)).astype(np.float32))
    cat.delete_targets([3])
    res, info = cat.query("norm", U, K)
    assert info.delta_scored == 6
    assert torch.all(res.n_scored >= base_res.n_scored + 6)
    assert torch.all(res.depth >= 1)


def test_tombstone_adaptive_overfetch():
    rng = _rng(6)
    cat = Pair(_base(rng), block_size=32)
    U = rng.standard_normal((1, R)).astype(np.float32)
    _, info = cat.query("norm", U, K)
    assert info.overfetch_k == K and not info.retried
    sv, sg = _oracle(cat, U, 400)
    kb_esc = min(cat.snapshot.num_rows, K + cat.overfetch_reserve)
    cat.delete_targets([int(g) for g in sg[0, -4:]])
    res, info = cat.query("norm", U, K)
    assert not info.retried and info.overfetch_k == kb_esc
    assert_exact(cat, U)
    cat.delete_targets([int(sg[0, 0])])
    res, info = cat.query("norm", U, K)
    assert not info.retried and info.overfetch_k == kb_esc
    assert int(sg[0, 0]) not in set(res.indices[0].tolist())
    assert_exact(cat, U)


def test_randomized_interleaving_always_exact():
    rng = _rng(7)
    cat = Pair(_base(rng, 150), delta_capacity=8, block_size=32)
    live = list(range(150))
    for step in range(60):
        op = rng.choice(["ins", "del", "upd", "query"],
                        p=[0.3, 0.2, 0.2, 0.3])
        if op == "ins":
            n = int(rng.integers(1, 4))
            gids = cat.add_targets(
                rng.standard_normal((n, R)).astype(np.float32) * 1.5)
            live.extend(int(g) for g in gids)
        elif op == "del" and len(live) > K + 2:
            victim = live.pop(int(rng.integers(len(live))))
            cat.delete_targets([victim])
        elif op == "upd" and live:
            gid = live[int(rng.integers(len(live)))]
            cat.update_targets(
                [gid], rng.standard_normal((1, R)).astype(np.float32) * 2)
        else:
            U = rng.standard_normal(
                (int(rng.integers(1, 5)), R)).astype(np.float32)
            assert_exact(cat, U)
    assert cat.stats.n_compactions >= 1
    assert_exact(cat, rng.standard_normal((3, R)).astype(np.float32))
    assert cat.num_live == len(live)
    cat.check_state()


def test_engines_agree_after_mutations():
    rng = _rng(8)
    cat = Pair(_base(rng, 300), block_size=32)
    cat.add_targets(rng.standard_normal((10, R)).astype(np.float32))
    cat.delete_targets([5, 6, 7])
    cat.update_targets([10], rng.standard_normal((1, R)).astype(np.float32))
    U = rng.standard_normal((4, R)).astype(np.float32)
    ref, _ = cat.query("naive", U, K)
    for name in ("ta", "bta", "norm", "topk_mips"):
        res, _ = cat.query(name, U, K)
        np.testing.assert_allclose(res.values.numpy(), ref.values.numpy(),
                                   atol=1e-4)
        np.testing.assert_array_equal(res.indices.numpy(),
                                      ref.indices.numpy())


def test_segmented_matches_rebuilt_engine_not_just_numpy():
    rng = _rng(9)
    cat = Pair(_base(rng, 250), delta_capacity=16, block_size=32)
    cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
    cat.delete_targets([int(g) for g in range(0, 20, 3)])
    U = rng.standard_normal((3, R)).astype(np.float32)
    res, _ = cat.query("bta", U, K)
    rv, rg = _rebuilt_engine_topk(cat, "bta", U, K)
    np.testing.assert_allclose(res.values.numpy(), rv, atol=1e-4)
    for b in range(3):
        assert set(res.indices[b].tolist()) == set(rg[b].tolist())


def test_delete_everything_then_recover():
    rng = _rng(10)
    cat = Pair(_base(rng, 30), delta_capacity=8, block_size=16)
    U = rng.standard_normal((2, R)).astype(np.float32)
    cat.delete_targets(list(range(30)))
    assert cat.num_live == 0
    res, _ = cat.query("norm", U, K)
    assert torch.all(res.values == -np.inf)
    assert torch.all(res.indices == -1)
    cat.compact()
    res, _ = cat.query("norm", U, K)
    assert torch.all(res.indices == -1)
    gids = cat.add_targets(rng.standard_normal((4, R)).astype(np.float32))
    res, _ = assert_exact(cat, U, k=3)
    assert set(res.indices[0].tolist()) <= {int(g) for g in gids}
    cat.check_state()


def test_background_compaction_with_concurrent_mutations():
    rng = _rng(11)
    cat = Pair(_base(rng, 300), delta_capacity=8, block_size=32,
               compact_async=True)
    U = rng.standard_normal((2, R)).astype(np.float32)
    cat.add_targets(rng.standard_normal((8, R)).astype(np.float32))
    cat.add_targets(rng.standard_normal((1, R)).astype(np.float32))
    cat.delete_targets([0, 1, 2])
    # a build races this query in each package on its own clock
    assert_exact(cat, U, counts=False)
    cat.flush()
    assert cat.stats.n_compactions == 1
    assert_exact(cat, U)
    assert cat.num_live == 300 + 9 - 3
    returned = set(cat.query("naive", U, 300)[0].indices.numpy().ravel()
                   .tolist())
    assert not (returned & {0, 1, 2})
    cat.check_state()


def test_version_monotone_and_snapshot_pytrees_stable():
    rng = _rng(12)
    cat = Pair(_base(rng, 100), delta_capacity=4, block_size=16)
    snap0 = cat.snapshot
    mask0 = snap0.dead_dev
    versions = [cat.version]
    for _ in range(3):
        cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
        versions.append(cat.version)
    assert versions == sorted(versions) and versions[-1] >= 1
    assert snap0.version == 0 and snap0.ctx.version == 0
    np.testing.assert_array_equal(snap0.gids_np, np.arange(100))
    # a kill writes a NEW mask: a query holding the old one keeps it
    snap = cat.snapshot
    held = snap.dead_dev
    cat.delete_targets([int(snap.gids_np[0])])
    assert snap.dead_dev is not held and not bool(held.any())
    assert bool(snap.dead_dev[0]) and not bool(mask0.any())
    cat.check_state()


def test_escalation_ladder_climbs_past_reserve():
    rng = _rng(17)
    T = rng.standard_normal((300, R)).astype(np.float32)
    u = rng.standard_normal(R).astype(np.float32)
    un = (u / np.linalg.norm(u)).astype(np.float32)
    n_top = 40
    T[:n_top] = un[None, :] * (
        10.0 + np.arange(n_top, dtype=np.float32))[:, None]
    cat = Pair(T, block_size=32)
    cat.delete_targets(list(range(n_top)))
    res, info = cat.query("norm", u[None], K)
    assert info.retried
    assert info.overfetch_k == min(
        300, K + ESCALATION_STEP * cat.overfetch_reserve)
    assert not (set(res.indices[0].tolist()) & set(range(n_top)))
    assert_exact(cat, u[None])


def test_mutation_batches_are_atomic_on_error():
    rng = _rng(14)
    cat = Pair(_base(rng, 60), block_size=16)
    with pytest.raises(KeyError):
        cat.delete_targets([5, 99999])
    with pytest.raises(KeyError):
        cat.delete_targets([7, 7])
    with pytest.raises(KeyError):
        cat.update_targets([6, 99999], np.zeros((2, R), np.float32))
    assert cat.num_live == 60
    assert cat.stats.n_deletes == 0 and cat.stats.n_updates == 0
    cat.delete_targets([5, 7])
    cat.update_targets([6], np.zeros((1, R), np.float32))
    assert cat.num_live == 58
    cat.check_state()


def test_update_same_gid_twice_in_one_batch_last_wins():
    rng = _rng(15)
    cat = Pair(_base(rng, 80), block_size=16)
    U = rng.standard_normal((2, R)).astype(np.float32)
    rows = np.stack([np.full(R, 9.0, np.float32),
                     rng.standard_normal(R).astype(np.float32)])
    cat.update_targets([3, 3], rows)
    assert cat.num_live == 80
    assert_exact(cat, U)
    rows_live, gids_live = cat.as_dense()
    np.testing.assert_array_equal(rows_live[list(gids_live).index(3)],
                                  rows[1])
    cat.check_state()


def _flaky_contexts(monkeypatch, failures=1, delay_s=0.0):
    """Make each package's next ``failures`` snapshot builds raise (and
    every build sleep ``delay_s``)."""
    for mod in (ref_seg_mod, seg_mod):
        real_ctx = mod.EngineContext
        left = {"n": failures}

        def flaky_ctx(*args, _real=real_ctx, _left=left, **kwargs):
            time.sleep(delay_s)
            if _left["n"]:
                _left["n"] -= 1
                raise RuntimeError("simulated snapshot build failure")
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, "EngineContext", flaky_ctx)


def test_failed_background_build_loses_nothing(monkeypatch):
    rng = _rng(16)
    cat = Pair(_base(rng, 120), delta_capacity=8, block_size=16,
               compact_async=True)
    U = rng.standard_normal((2, R)).astype(np.float32)
    _flaky_contexts(monkeypatch)
    gids = cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
    cat.flush()
    assert cat.stats.n_compactions == 0
    assert cat.stats.n_failed_compactions == 1
    assert isinstance(cat.last_build_error, RuntimeError)
    assert len(cat._frozen) == 1
    assert cat.num_live == 129
    res, info = assert_exact(cat, U)
    assert info.n_segments >= 1
    cat.delete_targets([int(gids[0])])
    cat.add_targets(rng.standard_normal((8, R)).astype(np.float32))
    cat.flush()
    assert cat.stats.n_compactions == 1
    assert not cat._frozen
    assert cat.num_live == 136
    assert_exact(cat, U)
    cat.check_state()


def test_noop_compact_keeps_snapshot_and_version():
    cat = Pair(_base(_rng(19), 50), block_size=16)
    snap = cat.snapshot
    cat.compact()
    assert cat.snapshot is snap and cat.version == 0
    assert cat.stats.n_compactions == 0
    cat.check_state()


def test_sync_build_failure_keeps_mutation_batches_atomic(monkeypatch):
    rng = _rng(20)
    cat = Pair(_base(rng, 100), delta_capacity=8, block_size=16)
    U = rng.standard_normal((2, R)).astype(np.float32)
    cat.add_targets(rng.standard_normal((8, R)).astype(np.float32))
    _flaky_contexts(monkeypatch)
    new_row = rng.standard_normal((1, R)).astype(np.float32)
    cat.update_targets([3], new_row)
    assert cat.stats.n_failed_compactions == 1
    assert cat.num_live == 108
    assert_exact(cat, U)
    rows_live, gids_live = cat.as_dense()
    np.testing.assert_array_equal(rows_live[list(gids_live).index(3)],
                                  new_row[0])
    cat.compact()
    assert cat.stats.n_compactions == 1 and not cat._frozen
    assert_exact(cat, U)
    cat.check_state()


def test_compaction_never_blocks_mutations(monkeypatch):
    rng = _rng(18)
    cat = SegmentedCatalogue(_base(rng, 150), delta_capacity=8,
                             block_size=16, compact_async=True, device="cpu")
    U = rng.standard_normal((2, R)).astype(np.float32)
    _flaky_contexts(monkeypatch, failures=0, delay_s=1.0)
    cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
    t0 = time.perf_counter()
    cat.add_targets(rng.standard_normal((16, R)).astype(np.float32))
    assert time.perf_counter() - t0 < 0.8   # sealed + returned, no join
    res, _ = cat.query(get_engine("norm"), U, K)
    ov, _ = _oracle(cat, U, K)
    np.testing.assert_allclose(res.values.numpy(), ov, atol=1e-4)
    cat.flush()
    assert not cat._frozen
    assert cat.stats.n_compactions >= 2
    assert cat.num_live == 175
    res, _ = cat.query(get_engine("norm"), U, K)
    np.testing.assert_allclose(res.values.numpy(), _oracle(cat, U, K)[0],
                               atol=1e-4)


def test_unknown_gid_raises():
    rng = _rng(13)
    cat = Pair(_base(rng, 50), block_size=16)
    cat.delete_targets([3])
    with pytest.raises(KeyError):
        cat.delete_targets([3])
    with pytest.raises(KeyError):
        cat.update_targets([999], [np.zeros(R, np.float32)])
    with pytest.raises(ValueError):
        cat.add_targets(np.zeros((1, R + 1), np.float32))
    cat.check_state()


# -- beyond the reference's cases ---------------------------------------------


def test_k_300_through_topk_mips_climbs_the_ladder():
    """k = 300 through the kernel engine, past the CUDA gate walk's
    shared-memory carry of 256: pristine, tombstoned (k + 32) and climbed
    (k + 4 * 32 = 428) fetches all equal the reference's."""
    rng = _rng(21)
    T = rng.standard_normal((900, R)).astype(np.float32)
    u = rng.standard_normal(R).astype(np.float32)
    un = (u / np.linalg.norm(u)).astype(np.float32)
    T[:40] = un[None, :] * (10.0 + np.arange(40, dtype=np.float32))[:, None]
    cat = Pair(T, block_size=64)
    U = np.stack([u, rng.standard_normal(R).astype(np.float32)])
    _, info = cat.query("topk_mips", U, 300)
    assert info.overfetch_k == 300
    cat.delete_targets([50])
    _, info = cat.query("topk_mips", U, 300)
    assert info.overfetch_k == 332 and not info.retried
    cat.delete_targets(list(range(40)))
    cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
    res, info = assert_exact(cat, U, k=300, engine="topk_mips")
    assert info.retried and info.overfetch_k == 428


def test_delta_views_copy_the_host_buffers():
    """A view a query holds never changes under a later append or kill."""
    cat = SegmentedCatalogue(_base(_rng(22), 40), block_size=16,
                             device="cpu")
    rows = _rng(23).standard_normal((2, R)).astype(np.float32)
    gids = cat.add_targets(rows[:1])
    view = cat._delta.device_view()
    held = [t.clone() for t in view]
    cat.add_targets(rows[1:])
    cat.delete_targets([int(gids[0])])
    for t, h in zip(view, held):
        assert torch.equal(t, h)
    assert not np.shares_memory(view[0].numpy(), cat._delta.rows)


def test_server_mutations_match_the_reference_server():
    """TopKServer's mutations, queries (every chunk), ServeStats'
    delta_scored and mutation_stats against the reference server; the
    stats validate under the ported schema."""
    rng = _rng(24)
    T = _base(rng, 260)
    ref = RefServer(RefModel(T), max_batch=4, block_size=32,
                    delta_capacity=8)
    srv = TopKServer(SepLRModel(T, device="cpu"), max_batch=4,
                     block_size=32, delta_capacity=8, device="cpu")
    U = rng.standard_normal((6, R)).astype(np.float32)
    rows = rng.standard_normal((11, R)).astype(np.float32)
    for s in (ref, srv):
        s.add_targets(rows[:7])
        s.delete_targets([1, 2, 262])
        s.update_targets([5, 261], rows[7:9])
    for method in ("bta", "topk_mips", "ta"):
        want = ref.query(U, 7, method={"topk_mips": "pallas"}.get(method,
                                                                   method))
        got = srv.query(U, 7, method=method)
        assert_same_result(got, want)
        a = srv.stats[method]
        b = ref.stats["pallas" if method == "topk_mips" else method]
        assert (a.n_queries, a.n_scored, a.depth_sum, a.delta_scored) == (
            b.n_queries, b.n_scored, b.depth_sum, b.delta_scored)
    for s in (ref, srv):
        s.add_targets(rows[9:])                 # overflow: a compaction
    got = srv.query(U, 7, method="norm")
    assert_same_result(got, ref.query(U, 7, method="norm"))
    ms, want = srv.mutation_stats, ref.mutation_stats
    assert obs.build_mutation_stats(ms) == ms
    assert set(ms) == set(obs.MUTATION_STATS_SCHEMA)
    timed = {"compaction_s_total", "last_compaction_s"}
    for key in set(ms) - timed:
        assert ms[key] == want[key], key
    assert ms["snapshot_version"] == 1 and ms["engine_compiles_total"] == 0
    assert srv.index is srv.ctx.index and srv.ctx.version == 1
    assert srv.trace_counts == {}           # no kernel loads on the CPU


def test_compaction_readies_the_old_snapshots_engines_before_the_swap():
    """A build prepares, on the new context and before the swap, the
    arguments (index, list layout, kernel catalogue) of every engine the
    old snapshot had prepared: the first query after the swap builds
    nothing."""
    rng = _rng(25)
    cat = SegmentedCatalogue(_base(rng, 300), delta_capacity=8,
                             block_size=32, prefix_depth=16, device="cpu")
    U = rng.standard_normal((2, R)).astype(np.float32)
    for name in ("bta", "topk_mips"):
        cat.query(get_engine(name), U, K)
    old = cat.snapshot.ctx
    cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
    new = cat.snapshot.ctx
    assert new is not old and new.version == 1
    assert sorted(new.prepared_engines) == sorted(old.prepared_engines) \
        == ["bta", "topk_mips"]
    assert new._index is not None and new._catalog is not None
    assert "list_major" in new._layouts
