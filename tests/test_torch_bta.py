"""Parity of the port's Block Threshold Algorithm (the ``bta`` engine, the
server's default method) with the JAX reference, on the CPU: the
list-major layout, sign buckets, the single-query and batched scans, the
registry engine, budgets, the server and the TA oracle.

Inputs are made with numpy from a seed and handed to both packages. The
reference pads its list arrays to the catalogue's M-bucket; the port runs
on the real M, and the reference promises that its padded scan equals the
unpadded one, so every field must agree: values within ``_torch_parity``'s
1e-5 relative (fp32 sums in other orders), ids wherever scores are
distinct, ``n_scored`` and ``depth`` exactly, and ``upper`` (an Eq. 3 sum
of R products) at the same 1e-5 relative. On CPU tensors the tail scorer
is kernel B4's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.blocked as blocked_mod
from repro.core.blocked import blocked_topk as ref_blocked_topk
from repro.core.engines import EngineContext as RefContext
from repro.core.engines import get_engine as ref_get_engine
from repro.core.index import build_index as ref_build_index
from repro.core.layout import build_list_major as ref_build_list_major
from repro.core.strategies import sign_bucket as ref_sign_bucket
from repro.core.strategies import sign_bucket_label as ref_sign_bucket_label
from repro.core.threshold import threshold_topk_np as ref_threshold_topk_np
from repro.serving.server import TopKServer as RefServer
from repro_torch.convert import INDEX_FIELDS, LIST_FIELDS, from_reference
from repro_torch.core.blocked import blocked_topk
from repro_torch.core.engines import EngineContext, get_engine
from repro_torch.core.layout import (ListMajorLayout, build_layout,
                                     build_list_major)
from repro_torch.core.strategies import sign_bucket, sign_bucket_label
from repro_torch.core.threshold import threshold_topk_np
from repro_torch.serving.server import TopKServer

from _torch_parity import assert_topk_equal, assert_values, host


def _regimes(rng, r, n=3):
    """Query batches of every sign bucket (dense and sparse)."""
    dense = rng.standard_normal((n, r)).astype(np.float32)
    mixed = dense.copy()
    mixed[:, ::2] *= -1.0
    zero = rng.random((n, r)) < 0.5
    zero[:, 0] = False                      # at least one active list
    return {
        "positive": np.abs(dense),
        "mixed_sign": mixed,
        "all_negative": -np.abs(dense),
        "sparse_positive": np.where(zero, 0.0, np.abs(dense)).astype(
            np.float32),
        "sparse_negative": np.where(zero, 0.0, -np.abs(dense)).astype(
            np.float32),
    }


def _mixed_batch(rng, r):
    """One batch spanning every sign pattern, with different stopping
    depths (the sparse query certifies far earlier)."""
    U = np.zeros((4, r), np.float32)
    U[0] = np.abs(rng.standard_normal(r)) + 0.05
    U[1] = -np.abs(rng.standard_normal(r)) - 0.05
    U[2] = rng.standard_normal(r)
    U[3] = np.abs(rng.standard_normal(r))
    U[3, ::2] = 0.0
    return U


def _assert_same(got, want):
    assert_topk_equal((got.values, got.indices), (want.values, want.indices))
    for f in ("n_scored", "depth"):
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    assert_values(got.upper, want.upper)


def _index_arrays(T):
    ref_idx = ref_build_index(jnp.asarray(T))
    idx = from_reference({f: np.asarray(getattr(ref_idx, f))
                          for f in INDEX_FIELDS}, device="cpu")
    return ref_idx, idx


def _layout_arrays(lay):
    return {f: (getattr(lay, f) if f == "prefix_depth"
                else None if getattr(lay, f) is None
                else np.asarray(getattr(lay, f))) for f in LIST_FIELDS}


# ---------------------------------------------------------------------------
# The list-major layout and the sign buckets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix_depth", [None, 1, 32, 4096])
def test_build_list_major_matches_reference(prefix_depth):
    T = np.random.default_rng(5).standard_normal((220, 10)).astype(
        np.float32)
    ref_idx, idx = _index_arrays(T)
    want = ref_build_list_major(T, ref_idx, prefix_depth=prefix_depth)
    got = build_list_major(T, idx, prefix_depth=prefix_depth)
    assert got.prefix_depth == want.prefix_depth
    for f, a in _layout_arrays(want).items():
        if f != "prefix_depth":
            np.testing.assert_array_equal(host(getattr(got, f)), a, f)
    assert got.prefix_steps(16) == want.prefix_steps(16)
    # the context resolves and caches the same layout
    ctx = EngineContext(T, index=idx, prefix_depth=prefix_depth,
                        device="cpu")
    if ctx.resolved_prefix_depth:
        lay = ctx.layout("list_major")
        assert lay is ctx.layout("list_major")
        np.testing.assert_array_equal(host(lay.head_rows),
                                      host(got.head_rows))


def test_single_sided_layouts_and_from_reference():
    T = np.random.default_rng(6).standard_normal((120, 6)).astype(np.float32)
    ref_idx, idx = _index_arrays(T)
    ref_lay = ref_build_list_major(T, ref_idx, prefix_depth=40)
    lay = from_reference(_layout_arrays(ref_lay), device="cpu")
    assert isinstance(lay, ListMajorLayout) and lay.prefix_depth == 40
    assert lay.sides == ref_lay.sides == ("head", "tail") and lay.two_sided
    for side, sign_ok in (("head", {1: True, -1: False, 0: False}),
                          ("tail", {1: False, -1: True, 0: False})):
        got, want = lay.sided(side), ref_lay.sided(side)
        assert got.sides == want.sides == (side,) and not got.two_sided
        for sign, ok in sign_ok.items():
            assert got.serves_sign(sign) == want.serves_sign(sign) == ok
        carried = from_reference(_layout_arrays(want), device="cpu")
        assert carried.sides == (side,)
        np.testing.assert_array_equal(host(carried.rank_by_item),
                                      np.asarray(want.rank_by_item))
    sided = build_layout("list_major", T, idx, prefix_depth=40,
                         sides=("tail",))
    assert sided.sides == ("tail",) and sided.head_rows is None
    with pytest.raises(ValueError, match="sides"):
        build_list_major(T, idx, sides=("up",))
    with pytest.raises(ValueError, match="side must be"):
        lay.sided("both")


def test_sign_bucket_matches_reference():
    rng = np.random.default_rng(4)
    batches = dict(_regimes(rng, 8))
    batches["mixed_sparse"] = np.float32([[1.0, 0.0, -2.0]])
    batches["empty"] = np.zeros((0, 3), np.float32)
    for name, U in batches.items():
        want = ref_sign_bucket(U)
        assert sign_bucket(U) == want, name
        assert sign_bucket(torch.from_numpy(U)) == want, name
        assert sign_bucket_label(want) == ref_sign_bucket_label(want)
    assert sign_bucket_label(()) == ref_sign_bucket_label(()) == "unbucketed"


# ---------------------------------------------------------------------------
# The registry engine: M = 2^n - 1 / 2^n / 2^n + 1, layout off (gather
# path), prefix overflow (16) and prefix hit (300), every sign bucket
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [255, 256, 257])
@pytest.mark.parametrize("prefix_depth", [0, 16, 300])
def test_bta_engine_matches_reference(m, prefix_depth):
    rng = np.random.default_rng(300 + m + prefix_depth)
    r, k = 7, 5
    T = rng.standard_normal((m, r)).astype(np.float32)
    ref_ctx = RefContext(jnp.asarray(T), block_size=16,
                         prefix_depth=prefix_depth)
    ctx = EngineContext(T, block_size=16, prefix_depth=prefix_depth,
                        device="cpu")
    batches = dict(_regimes(rng, r), mixed_batch=_mixed_batch(rng, r))
    for regime, U in batches.items():
        want = ref_get_engine("bta").run(ref_ctx, jnp.asarray(U), k)
        got = get_engine("blocked").run(ctx, U, k)
        assert got.values.shape == (U.shape[0], k), regime
        _assert_same(got, want)
    # which phases ran: the gather path with the layout off, the tail
    # when the prefix (one block) is overflowed
    steps = ctx.scan_steps
    if prefix_depth == 0:
        assert steps["gather"] > 0 and steps["prefix"] == 0
    else:
        assert steps["prefix"] > 0 and steps["gather"] == 0
    if prefix_depth == 16:
        assert steps["tail"] > 0


def test_tail_runs_and_scores_through_the_tail_scorer(monkeypatch):
    """At prefix_depth=16 (one block of 16) the queries outlive the prefix:
    every tail step is one call of the tail scorer on all live lanes."""
    calls = []
    real = blocked_mod.gather_scores

    def counting(T, ids, U):
        calls.append(tuple(ids.shape))
        return real(T, ids, U)

    monkeypatch.setattr(blocked_mod, "gather_scores", counting)
    rng = np.random.default_rng(9)
    T = rng.standard_normal((400, 8)).astype(np.float32)
    U = rng.standard_normal((6, 8)).astype(np.float32)
    ctx = EngineContext(T, block_size=16, prefix_depth=16, device="cpu")
    res = get_engine("bta").run(ctx, U, 5)
    assert ctx.scan_steps["prefix"] == 1
    assert len(calls) == ctx.scan_steps["tail"] > 0
    assert all(len(s) == 2 and s[1] == 8 * 16 for s in calls)
    assert calls[0][0] == 8                  # the padded batch of 8, all live
    assert int(host(res.depth).max()) == 16 * (1 + len(calls))
    _assert_same(res, ref_get_engine("bta").run(
        RefContext(jnp.asarray(T), block_size=16, prefix_depth=16),
        jnp.asarray(U), 5))


@pytest.mark.parametrize("budget", [1, 40, 100000])
def test_budgeted_bta_matches_reference(budget):
    rng = np.random.default_rng(11)
    T = rng.standard_normal((500, 9)).astype(np.float32)
    U = _mixed_batch(rng, 9)
    ref_ctx = RefContext(jnp.asarray(T), block_size=16, prefix_depth=64)
    ctx = EngineContext(T, block_size=16, prefix_depth=64, device="cpu")
    want = ref_get_engine("bta").run(ref_ctx, jnp.asarray(U), 5,
                                     budget=budget)
    got = get_engine("bta").run(ctx, U, 5, budget=budget)
    _assert_same(got, want)
    if budget == 40:
        # halted at ceil(40 / 16) = 3 blocks, the bound kept finite
        assert (host(got.depth) <= 48).all()
        assert np.isfinite(host(got.upper)).any()
    # the context's own block cap, tightened by the budget
    halted = get_engine("bta").run(
        EngineContext(T, block_size=16, prefix_depth=64, max_blocks=2,
                      device="cpu"), U, 5, budget=budget)
    _assert_same(halted, ref_get_engine("bta").run(
        RefContext(jnp.asarray(T), block_size=16, prefix_depth=64,
                   max_blocks=2), jnp.asarray(U), 5, budget=budget))
    assert (host(halted.depth) <= 32).all()


def test_k_past_the_catalogue_pads_like_naive():
    T = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    ctx = EngineContext(T, block_size=16, prefix_depth=0, device="cpu")
    U = np.ones((2, 4), np.float32)
    got = get_engine("bta").run(ctx, U, 7)
    want = get_engine("naive").run(ctx, U, 7)
    assert got.values.shape == want.values.shape == (2, 7)
    with np.errstate(invalid="ignore"):     # gaps between -inf pad slots
        assert_topk_equal((got.values, got.indices),
                          (want.values, want.indices))


# ---------------------------------------------------------------------------
# One query: the bitmap, rank_desc and layout paths; the TA oracle
# ---------------------------------------------------------------------------
# "bitmap" is the reference's path without ``rank_desc`` (a visited
# bitmap); the port answers it as the batch of one with ranks worked out
# from ``order_desc``.


@pytest.mark.parametrize("path", ["bitmap", "rank_desc", "layout"])
def test_blocked_topk_one_query_matches_reference(path):
    rng = np.random.default_rng(13)
    T = rng.standard_normal((300, 10)).astype(np.float32)
    ref_idx, idx = _index_arrays(T)
    ref_lay = lay = None
    if path == "layout":
        ref_lay = ref_build_list_major(T, ref_idx, prefix_depth=32)
        lay = build_list_major(T, idx, prefix_depth=32)
    for regime, U in _regimes(rng, 10, n=2).items():
        for u in U:
            want = ref_blocked_topk(
                jnp.asarray(T), ref_idx.order_desc, ref_idx.t_sorted_desc,
                jnp.asarray(u), 6, block_size=16,
                rank_desc=ref_idx.rank_desc if path == "rank_desc" else None,
                layout=ref_lay)
            got = blocked_topk(
                torch.from_numpy(T), idx.order_desc, idx.t_sorted_desc,
                torch.from_numpy(u), 6, block_size=16,
                rank_desc=idx.rank_desc if path == "rank_desc" else None,
                layout=lay)
            _assert_same(got, want)


def test_threshold_oracle_copy_matches_reference():
    rng = np.random.default_rng(17)
    T = rng.standard_normal((150, 8)).astype(np.float32)
    od = np.asarray(ref_build_index(jnp.asarray(T)).order_desc)
    for U in _regimes(rng, 8, n=2).values():
        for u in U:
            v, i, st = threshold_topk_np(T, od, u, 5, track_trajectory=True)
            rv, ri, rst = ref_threshold_topk_np(T, od, u, 5,
                                                track_trajectory=True)
            np.testing.assert_array_equal(v, rv)
            np.testing.assert_array_equal(i, ri)
            assert (st.n_scored, st.depth, st.found_at) == (
                rst.n_scored, rst.depth, rst.found_at)
            np.testing.assert_array_equal(st.upper_bounds, rst.upper_bounds)


@pytest.mark.parametrize("prefix_depth", [0, 12])
def test_bta_block_one_reproduces_the_ta_oracle(prefix_depth):
    """``block_size=1`` is TA's round structure: values, ids, n_scored and
    depth equal the item-at-a-time oracle's, on the one-query scan and
    through the engine (prefix 12 overflows into the tail)."""
    rng = np.random.default_rng(19)
    T = rng.standard_normal((180, 8)).astype(np.float32)
    _, idx = _index_arrays(T)
    ctx = EngineContext(T, index=idx, block_size=1,
                        prefix_depth=prefix_depth, device="cpu")
    od = host(idx.order_desc)
    for regime, U in _regimes(rng, 8, n=2).items():
        res = get_engine("bta").run(ctx, U, 5)
        for b, u in enumerate(U):
            ov, oi, st = threshold_topk_np(T, od, u, 5)
            one = blocked_topk(torch.from_numpy(T), idx.order_desc,
                               idx.t_sorted_desc, torch.from_numpy(u), 5,
                               block_size=1, rank_desc=idx.rank_desc)
            for got in (one, tuple(x[b] for x in res)):
                assert_topk_equal((got[0], got[1]),
                                  (ov.astype(np.float32), oi))
                assert int(got[2]) == st.n_scored, regime
                assert int(got[3]) == st.depth, regime


# ---------------------------------------------------------------------------
# The server's default method
# ---------------------------------------------------------------------------


def test_server_default_method_is_bta_and_matches_reference():
    rng = np.random.default_rng(23)
    T = rng.standard_normal((700, 12)).astype(np.float32)
    from repro.core.seplr import SepLRModel as RefModel
    ref = RefServer(RefModel(jnp.asarray(T)), max_batch=16, block_size=32)
    srv = TopKServer(from_reference({"targets": T}, device="cpu"),
                     max_batch=16, block_size=32, device="cpu")
    U = np.concatenate([_mixed_batch(rng, 12)] * 5)         # 20: two chunks
    want = ref.query(jnp.asarray(U), 8)
    got = srv.query(U, 8)
    assert isinstance(got.values, np.ndarray) and got.values.shape == (20, 8)
    _assert_same(got, want)
    a, b = srv.stats["bta"], ref.stats["bta"]
    assert (a.n_queries, a.n_scored, a.depth_sum) == (
        b.n_queries, b.n_scored, b.depth_sum)
    assert a.sign_batches == b.sign_batches == {"unbucketed": 2}
