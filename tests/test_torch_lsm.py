"""The port's LSM ladder against the reference's, on the CPU.

``round_robin_shares`` and ``shard_fold_topk`` are held against the
reference's functions (ids id for id on distinct scores, values at 1e-5
relative + 1e-4 absolute). The ladder's cases of
``tests/test_streaming_properties.py`` (the steady state that folds
without a kernel library load; the ladder and the flat catalogue
agreeing, here a seeded sweep) and the four LSM cases of
``tests/test_faults.py`` run through both packages in lockstep
(:class:`_torch_streaming_pair.Pair` with ``n_shards``): every query's
values, ids, ``n_scored``, ``depth`` and ``QueryInfo`` and every counted
statistic equal the reference's. ``test_norm_sharded_engine_on_ladder_is_
exact`` needs the ``norm_sharded`` engine (ROADMAP A5) and waits for it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SepLRModel as RefModel
from repro.core.driver import NEG_INF
from repro.core.layout import round_robin_shares as ref_round_robin_shares
from repro.core.sharded import shard_fold_topk as ref_shard_fold_topk
from repro.obs.schema import MUTATION_STATS_SCHEMA as REF_SCHEMA
from repro.serving.server import TopKServer as RefServer
from repro_torch.core import (SegmentedCatalogue, SepLRModel,
                              ShardedLsmCatalogue, get_engine)
from repro_torch.core.layout import round_robin_shares
from repro_torch.core.sharded import shard_fold_topk
from repro_torch.obs.schema import (MUTATION_STATS_SCHEMA,
                                    build_mutation_stats)
from repro_torch.serving.server import TopKServer

from _torch_parity import assert_ids_where_distinct, host
from _torch_streaming_pair import (Pair, arm_both, assert_same_result,
                                   disarm_all_both)

R = 10
K = 5
#: the values' tolerance of the two merges (fp32 sums in two orders)
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _clean_faults():
    disarm_all_both()
    yield
    disarm_all_both()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _base(rng, m=200, r=R):
    return rng.standard_normal((m, r)).astype(np.float32)


def _oracle(cat, U, k):
    rows, gids = cat.as_dense()
    U = np.atleast_2d(np.asarray(U, np.float32))
    s = U.astype(np.float64) @ rows.astype(np.float64).T
    order = np.argsort(-s, kind="stable", axis=1)[:, :k]
    return s[np.arange(U.shape[0])[:, None], order], gids[order]


def assert_exact(cat, U, k=K, engine="norm"):
    """The pair's query (the port held against the reference) against
    the float64 oracle over the live rows."""
    res, info = cat.query(engine, U, k)
    ov, _ = _oracle(cat, U, k)
    kk = min(k, cat.num_live)
    np.testing.assert_allclose(host(res.values)[:, :kk], ov[:, :kk],
                               atol=1e-4)
    return res, info


def _lsm(rng, m=64, **kw):
    kw.setdefault("n_shards", 4)
    kw.setdefault("delta_capacity", 4)
    kw.setdefault("l1_capacity", 64)
    kw.setdefault("compact_async", False)
    kw.setdefault("build_backoff_s", 0.0)
    kw.setdefault("block_size", 16)
    return Pair(_base(rng, m), **kw)


# -- the two helpers ---------------------------------------------------------

@pytest.mark.parametrize("n,shards,start", [
    (0, 1, 0), (7, 1, 0), (7, 4, 0), (7, 4, 3), (13, 8, 5), (64, 8, 7),
    (3, 8, 6), (9, 4, 11)])
def test_round_robin_shares_match_reference(n, shards, start):
    got = round_robin_shares(n, shards, start)
    want = ref_round_robin_shares(n, shards, start)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == n


@pytest.mark.parametrize("shards,b,c,k,per_lane", [
    (1, 3, 8, 4, False), (4, 5, 16, 6, False), (8, 2, 8, 10, False),
    (4, 3, 16, 5, True)])
def test_shard_fold_topk_matches_reference(shards, b, c, k, per_lane):
    """Distinct scores (a continuous draw), dead lanes at -inf with gid
    -1, a carry of k entries with padding: the fold equals the
    reference's, id for id."""
    rng = _rng(shards * 100 + c)
    carry_v = np.sort(rng.standard_normal((b, k)).astype(np.float32),
                      axis=1)[:, ::-1].copy()
    carry_i = rng.permutation(10_000)[:b * k].reshape(b, k).astype(np.int32)
    carry_v[:, -2:] = -np.inf
    carry_i[:, -2:] = -1
    scores = rng.standard_normal((shards, b, c)).astype(np.float32)
    gshape = (shards, b, c) if per_lane else (shards, c)
    gids = (10_000 + np.arange(int(np.prod(gshape)))).reshape(
        gshape).astype(np.int32)
    dead = rng.random(gshape) < 0.3
    gids[dead] = -1
    dead_b = dead if per_lane else np.broadcast_to(dead[:, None, :],
                                                   scores.shape)
    scores[dead_b] = NEG_INF
    want_v, want_i = ref_shard_fold_topk(
        jnp.asarray(carry_v), jnp.asarray(carry_i), jnp.asarray(scores),
        jnp.asarray(gids), k)
    got_v, got_i = shard_fold_topk(
        torch.from_numpy(carry_v), torch.from_numpy(carry_i),
        torch.from_numpy(scores), torch.from_numpy(gids), k)
    np.testing.assert_allclose(host(got_v), np.asarray(want_v), rtol=RTOL,
                               atol=ATOL)
    assert_ids_where_distinct(got_i, want_i, want_v)


# -- tests/test_streaming_properties.py's deterministic ladder cases --------

def test_steady_state_folds_are_compile_free():
    """After warm(), a stream whose overflows the L0 -> L1 folds absorb
    loads no kernel library (the port's compile) and runs no full
    rebuild; the reference, in lockstep, traces no new tail."""
    rng = _rng(3)
    cat = Pair(_base(rng, 64, 6), n_shards=4, delta_capacity=4,
               l1_capacity=64, block_size=8, compact_async=False)
    cat.ref.warm(K)
    cat.port.warm(K)
    U = rng.standard_normal((2, 6)).astype(np.float32)
    for _ in range(4):
        cat.add_targets(rng.standard_normal((5, 6)).astype(np.float32))
        cat.query("norm", U, K)
    folds0 = cat.stats.n_l1_folds
    tails0 = cat.ref.trace_counts.get("segmented_tail", 0)
    for _ in range(6):
        cat.add_targets(rng.standard_normal((5, 6)).astype(np.float32))
        assert_exact(cat, U)
    assert cat.stats.n_l1_folds > folds0          # the stream DID fold
    assert cat.stats.n_compactions == 0           # ...never a full rebuild
    assert cat.stats.engine_compiles_total == 0
    assert cat.ref.trace_counts.get("segmented_tail", 0) == tails0
    cat.check_state()


_CLEAN_KINDS = ["insert", "delete", "update", "query", "compact", "flush"]
_CLEAN_WEIGHTS = [0.34, 0.14, 0.14, 0.2, 0.12, 0.06]


@pytest.mark.parametrize("seed", range(12))
def test_ladder_and_flat_catalogue_agree(seed):
    """The SAME fault-free schedule on the ladder (in lockstep with the
    reference's) and on the port's single-level catalogue ends in the SAME
    visible contents, and both answer every query exactly."""
    rng = _rng(seed)
    n_shards = [1, 4, 8][int(rng.integers(3))]
    m0 = [7, 8, 9, 15, 16, 17, 31, 32, 33][int(rng.integers(9))]
    positive = bool(rng.integers(2))
    ops = []
    for _ in range(int(rng.integers(1, 25))):
        kind = str(rng.choice(_CLEAN_KINDS, p=_CLEAN_WEIGHTS))
        ops.append((kind, int(rng.integers(1, 7)) if kind == "insert"
                    else int(rng.integers(0, 64))))
    base = rng.standard_normal((m0, 6)).astype(np.float32)
    if positive:
        base = np.abs(base)
    kw = dict(delta_capacity=4, block_size=8, compact_async=False,
              build_backoff_s=0.0, max_l0_segments=8)
    lsm = Pair(base, n_shards=n_shards, l1_capacity=8, **kw)
    flat = SegmentedCatalogue(base, device="cpu", **kw)
    shadow = {i: base[i] for i in range(m0)}
    draw = np.random.default_rng(seed + 1)

    def rows(n):
        r = draw.standard_normal((n, 6)).astype(np.float32)
        return np.abs(r) if positive else r

    for kind, arg in ops:
        if kind == "insert":
            new = rows(arg)
            got = lsm.add_targets(new)
            np.testing.assert_array_equal(flat.add_targets(new), got)
            shadow.update((int(g), r) for g, r in zip(got, new))
        elif kind in ("delete", "update") and shadow:
            victim = sorted(shadow)[arg % len(shadow)]
            if kind == "delete":
                lsm.delete_targets([victim])
                flat.delete_targets([victim])
                del shadow[victim]
            else:
                row = rows(1)
                lsm.update_targets([victim], row)
                flat.update_targets([victim], row)
                shadow[victim] = row[0]
        elif kind == "query":
            U = rows(2)
            got, _ = assert_exact(lsm, U, K)
            want, _ = flat.query(get_engine("norm"), U, K)
            np.testing.assert_allclose(host(got.values), host(want.values),
                                       rtol=RTOL, atol=ATOL)
        elif kind == "compact":
            lsm.compact(wait=True)
            flat.compact(wait=True)
        elif kind == "flush":
            lsm.flush()
            flat.flush()
    lsm.check_state()
    dl = {int(g): r for g, r in zip(*lsm.as_dense()[::-1])}
    df = {int(g): r for g, r in zip(*flat.as_dense()[::-1])}
    assert set(dl) == set(df) == set(shadow)
    for g in shadow:
        np.testing.assert_array_equal(dl[g], df[g])
        np.testing.assert_array_equal(dl[g], shadow[g])
    assert_exact(lsm, rows(2))


# -- tests/test_faults.py's LSM ladder cases --------------------------------

def test_consecutive_fold_failures_chain_stays_exact():
    """N consecutive injected L0 -> L1 fold failures: nothing is lost,
    the sealed chain keeps growing AND answering exactly, and the first
    healthy fold drains it wholesale."""
    rng = _rng(31)
    cat = _lsm(rng)
    U = rng.standard_normal((2, R)).astype(np.float32)
    arm_both("compaction.fold_l1", error=RuntimeError, times=3)
    for i in range(3):
        cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
        assert cat.stats.n_failed_l1_folds == i + 1
        assert cat.consecutive_fold_failures == i + 1
        assert cat.l0_chain_len >= 1
        assert cat.l1_rows == 0
        assert_exact(cat, U)
    assert cat.stats.n_l1_fold_retries >= 2
    assert isinstance(cat.last_fold_error, RuntimeError)
    cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
    assert cat.stats.n_l1_folds >= 1
    assert cat.consecutive_fold_failures == 0
    assert cat.fold_backoff_s == 0.0
    assert cat.l0_chain_len == 0
    assert cat.l1_rows > 0
    assert cat.stats.n_compactions == 0
    assert_exact(cat, U)
    cat.check_state()


def test_fold_failure_backoff_gates_ordinary_folds():
    """After >= 2 consecutive fold failures a non-forced fold waits out
    an exponential backoff instead of hammering the failing seam."""
    rng = _rng(32)
    cat = _lsm(rng, build_backoff_s=30.0, build_backoff_max_s=60.0)
    arm_both("compaction.fold_l1", error=RuntimeError, times=2)
    for _ in range(2):
        cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
    assert cat.consecutive_fold_failures == 2
    assert cat.fold_backoff_s >= 30.0
    chain = cat.l0_chain_len
    cat.add_targets(rng.standard_normal((5, R)).astype(np.float32))
    assert cat.stats.n_l1_folds == 0
    assert cat.l0_chain_len > chain
    assert_exact(cat, rng.standard_normal((1, R)).astype(np.float32))
    cat.check_state()


def test_promote_fault_is_a_build_failure_and_tier_survives():
    """compaction.promote fires BEFORE anything moves: a failed promotion
    is recorded as a build failure, every tier keeps serving, and the
    healed retry flattens the ladder completely."""
    rng = _rng(33)
    cat = _lsm(rng)
    cat.add_targets(rng.standard_normal((9, R)).astype(np.float32))
    assert cat.l1_rows > 0
    U = rng.standard_normal((2, R)).astype(np.float32)
    arm_both("compaction.promote", error=RuntimeError, times=1)
    with pytest.raises(RuntimeError):
        cat.promote(wait=True)
    assert cat.stats.n_failed_compactions == 1
    assert cat.l1_rows > 0
    assert_exact(cat, U)
    cat.promote(wait=True)
    assert cat.l1_rows == 0 and cat.l0_chain_len == 0
    assert cat.stats.n_compactions >= 1
    assert_exact(cat, U)
    cat.check_state()


def test_lsm_stats_flow_through_mutation_schema():
    """The ladder's stats extend mutation_stats without schema drift, on
    both servers alike; the single-level server reports neutral ladder
    values through the same schema."""
    rng = _rng(34)
    T, rows = _base(rng, 48), _base(rng, 10)
    ref = RefServer(RefModel(T), n_shards=4, delta_capacity=4,
                    compact_async=False, block_size=16)
    srv = TopKServer(SepLRModel(T, device="cpu"), n_shards=4,
                     delta_capacity=4, compact_async=False, block_size=16,
                     device="cpu")
    assert isinstance(srv.catalogue, ShardedLsmCatalogue)
    ref.add_targets(rows)
    srv.add_targets(rows)
    stats, want = srv.mutation_stats, ref.mutation_stats
    assert set(stats) == set(MUTATION_STATS_SCHEMA) == set(REF_SCHEMA)
    assert stats["n_shards"] == 4
    assert stats["n_l1_folds"] >= 1
    for key, v in want.items():
        if not key.endswith("_s") and not key.endswith("_s_total") \
                and "compiles" not in key:
            assert stats[key] == v, key
    assert build_mutation_stats(stats) == stats
    with pytest.raises(KeyError):
        build_mutation_stats({k: v for k, v in stats.items()
                              if k != "fold_backoff_s"})
    with pytest.raises(KeyError):
        build_mutation_stats({**stats, "surprise": 1})
    flat = TopKServer(SepLRModel(_base(rng, 32), device="cpu"),
                      delta_capacity=8, block_size=16, device="cpu")
    fs = flat.mutation_stats
    assert fs["n_shards"] == 0 and fs["l1_rows"] == 0
    assert build_mutation_stats(fs) == fs


# -- the servers over the ladder --------------------------------------------

@pytest.mark.parametrize("method", ["norm", "topk_mips", "bta"])
def test_sharded_server_matches_reference_server(method):
    """TopKServer(n_shards=4) on the CPU against the reference's through
    folds, kills in L1 runs and the base, an update, a promotion: values,
    ids and n_scored equal at every query."""
    rng = _rng(35)
    T = _base(rng, 300)
    ref = RefServer(RefModel(T), n_shards=4, delta_capacity=8,
                    block_size=32)
    srv = TopKServer(SepLRModel(T, device="cpu"), n_shards=4,
                     delta_capacity=8, block_size=32, device="cpu")
    ref_method = "pallas" if method == "topk_mips" else method
    U = rng.standard_normal((6, R)).astype(np.float32)

    def both(fn):
        return fn(ref), fn(srv)

    def served():
        want = ref.query(jnp.asarray(U), K, method=ref_method)
        got = srv.query(U, K, method=method)
        assert_same_result(got, want)

    rows = _base(rng, 40)
    new = both(lambda s: s.add_targets(rows))[1]
    assert srv.catalogue.l1_rows > 0 and srv.catalogue.stats.n_l1_folds
    served()
    both(lambda s: s.delete_targets([int(new[0]), int(new[3]), 5, 17]))
    both(lambda s: s.update_targets([int(new[7]), 2], U[:2] * 3.0))
    served()
    both(lambda s: s.catalogue.promote(wait=True))
    assert srv.catalogue.l1_rows == 0 and srv.catalogue.stats.n_compactions
    served()
    assert srv.mutation_stats["num_live"] == ref.mutation_stats["num_live"]
