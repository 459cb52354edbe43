"""Parity of the port's Threshold Algorithm (the ``ta`` engine, alias
``threshold``: chunked TA, count-faithful to the paper's Algorithm 2) with
the JAX reference, on the CPU: the registry engine over the gather path,
the prefix overflowing into the tail and the prefix alone, every chunk
size, every sign bucket, halted TA, the TA entry points, the server, and
the item-at-a-time oracle ``threshold_topk_np``.

Inputs are made with numpy from a seed and handed to both packages. The
reference pads its list arrays to the catalogue's M-bucket; the port runs
on the real M (777 and 1,000 are not multiples of any chunk, so a chunk
straddles the catalogue's end). Every field must agree: values within
``_torch_parity``'s 1e-5 relative (fp32 sums in other orders), ids
wherever scores are distinct, ``n_scored`` and ``depth`` (in rounds)
exactly, and ``upper`` (an Eq. 3 sum of R products) at the same 1e-5
relative. On CPU tensors the tail scorer is kernel B4's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.blocked as blocked_mod
import repro_torch.core.driver as driver_mod
from repro.core.blocked import chunked_ta_topk as ref_chunked_ta_topk
from repro.core.blocked import \
    chunked_ta_topk_batched as ref_chunked_ta_topk_batched
from repro.core.engines import EngineContext as RefContext
from repro.core.engines import get_engine as ref_get_engine
from repro.core.index import build_index as ref_build_index
from repro.core.layout import build_list_major as ref_build_list_major
from repro.core.seplr import SepLRModel as RefModel
from repro.core.threshold import \
    threshold_topk_batched_from_index as ref_threshold_batched
from repro.core.threshold import \
    threshold_topk_from_index as ref_threshold_from_index
from repro.serving.server import TopKServer as RefServer
from repro_torch.convert import INDEX_FIELDS, from_reference
from repro_torch.core import (chunked_ta_topk, chunked_ta_topk_batched,
                              threshold_topk, threshold_topk_from_index)
from repro_torch.core.engines import EngineContext, get_engine
from repro_torch.core.layout import build_list_major
from repro_torch.core.threshold import (threshold_topk_batched_from_index,
                                        threshold_topk_np)
from repro_torch.serving.server import TopKServer

from _torch_parity import assert_topk_equal, assert_values, host

R, K = 8, 5


def _batches(rng, r=R, n=3):
    """Query batches of every sign bucket (dense and sparse), and one batch
    spanning every sign pattern (its lanes stop at different rounds)."""
    dense = rng.standard_normal((n, r)).astype(np.float32)
    mixed = dense.copy()
    mixed[:, ::2] *= -1.0
    zero = rng.random((n, r)) < 0.5
    zero[:, 0] = False                      # at least one active list
    every = np.zeros((4, r), np.float32)
    every[0] = np.abs(rng.standard_normal(r)) + 0.05
    every[1] = -np.abs(rng.standard_normal(r)) - 0.05
    every[2] = rng.standard_normal(r)
    every[3] = np.abs(rng.standard_normal(r))
    every[3, ::2] = 0.0
    return {
        "mixed_sign": mixed,
        "non_negative": np.abs(dense),
        "non_positive": -np.abs(dense),
        "sparse_non_negative": np.where(zero, 0.0, np.abs(dense)).astype(
            np.float32),
        "sparse_non_positive": np.where(zero, 0.0, -np.abs(dense)).astype(
            np.float32),
        "every_sign": every,
    }


def _some_batches(rng):
    """One batch of three sign buckets (mixed, non-positive dense,
    non-negative sparse): the entry points' reference compiles once per
    bucket."""
    b = _batches(rng, n=2)
    return {key: b[key] for key in ("every_sign", "non_positive",
                                    "sparse_non_negative")}


def _assert_same(got, want):
    assert_topk_equal((got.values, got.indices), (want.values, want.indices))
    for f in ("n_scored", "depth"):
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    assert_values(got.upper, want.upper)


def _assert_oracle(res, T, order_desc, U, k=K):
    """Each lane's values, ids, n_scored and depth against the
    item-at-a-time oracle."""
    for b, u in enumerate(U):
        ov, oi, st = threshold_topk_np(T, order_desc, u, k)
        assert_topk_equal((host(res.values)[b], host(res.indices)[b]),
                          (ov.astype(np.float32), oi))
        assert int(host(res.n_scored)[b]) == st.n_scored, b
        assert int(host(res.depth)[b]) == st.depth, b


def _index_arrays(T):
    ref_idx = ref_build_index(jnp.asarray(T))
    idx = from_reference({f: np.asarray(getattr(ref_idx, f))
                          for f in INDEX_FIELDS}, device="cpu")
    return ref_idx, idx


# ---------------------------------------------------------------------------
# The registry engine: the gather path (prefix 0 and the default, which is
# off below LIST_LAYOUT_MIN_TARGETS), a prefix the scans overflow (40),
# chunks of 1, 8 and 32 rounds, every sign bucket; counts against the
# oracle at every chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 8, 32])
@pytest.mark.parametrize("prefix_depth", [0, 40, None])
@pytest.mark.parametrize("m", [777, 1000])
def test_ta_engine_matches_reference_and_oracle(m, prefix_depth, chunk):
    rng = np.random.default_rng(1000 * chunk + m + (prefix_depth or 0))
    T = rng.standard_normal((m, R)).astype(np.float32)
    ref_ctx = RefContext(jnp.asarray(T), ta_chunk=chunk,
                         prefix_depth=prefix_depth)
    ctx = EngineContext(T, ta_chunk=chunk, prefix_depth=prefix_depth,
                        device="cpu")
    od = host(ctx.index.order_desc)
    for regime, U in _batches(rng).items():
        want = ref_get_engine("ta").run(ref_ctx, jnp.asarray(U), K)
        got = get_engine("threshold").run(ctx, U, K)
        assert got.values.shape == (U.shape[0], K), regime
        _assert_same(got, want)
        _assert_oracle(got, T, od, U)
    # which phases ran: the gather path with the layout off; the prefix,
    # then the tail, when it is on (40 rounds: every scan outlives it)
    steps = ctx.scan_steps
    if not prefix_depth:
        assert steps["gather"] > 0 and steps["prefix"] == 0
    else:
        assert steps["prefix"] > 0 and steps["tail"] > 0
        assert steps["gather"] == 0


def test_round_replay_taken_a_piece_of_lanes_at_a_time(monkeypatch):
    """The replay's ``[L, chunk, K + C]`` count in pieces of one lane
    gives what it gives in one piece, in the prefix and in the tail."""
    rng = np.random.default_rng(31)
    T = rng.standard_normal((777, R)).astype(np.float32)
    U = _batches(rng)["every_sign"]
    ctx = EngineContext(T, ta_chunk=8, prefix_depth=40, device="cpu")
    whole = get_engine("ta").run(ctx, U, K)
    monkeypatch.setattr(driver_mod, "KEY_PIECE_ELEMS", 1)
    assert len(driver_mod.lane_pieces(4, 8 * (K + 8 * R))) == 4
    pieces = get_engine("ta").run(ctx, U, K)
    for a, b in zip(whole, pieces):
        np.testing.assert_array_equal(host(a), host(b))


def test_tail_runs_and_scores_through_the_tail_scorer(monkeypatch):
    """At prefix_depth=16 with chunks of 8 the queries outlive the two
    prefix steps: every tail step is one call of the tail scorer on all
    live lanes, over ``R * chunk`` ids."""
    calls = []
    real = blocked_mod.gather_scores

    def counting(T, ids, U):
        calls.append(tuple(ids.shape))
        return real(T, ids, U)

    monkeypatch.setattr(blocked_mod, "gather_scores", counting)
    rng = np.random.default_rng(9)
    T = rng.standard_normal((400, R)).astype(np.float32)
    U = rng.standard_normal((6, R)).astype(np.float32)
    ctx = EngineContext(T, ta_chunk=8, prefix_depth=16, device="cpu")
    res = get_engine("ta").run(ctx, U, K)
    assert ctx.scan_steps["prefix"] == 2
    assert len(calls) == ctx.scan_steps["tail"] > 0
    assert all(len(s) == 2 and s[1] == R * 8 for s in calls)
    assert calls[0][0] == 8                  # the padded batch of 8, all live
    assert int(host(res.depth).max()) > 16
    _assert_same(res, ref_get_engine("ta").run(
        RefContext(jnp.asarray(T), ta_chunk=8, prefix_depth=16),
        jnp.asarray(U), K))


# ---------------------------------------------------------------------------
# Halted TA: budgets in rounds, held even in mid-chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("budget", [3, 21, 45, 100000])
def test_halted_ta_matches_reference(budget, chunk):
    """Budgets 3 and 21 stop in mid-chunk inside the 40-round prefix, 45
    in mid-chunk past it (in the tail), 100,000 never."""
    rng = np.random.default_rng(41 + budget)
    T = rng.standard_normal((777, R)).astype(np.float32)
    ref_ctx = RefContext(jnp.asarray(T), ta_chunk=chunk, prefix_depth=40)
    ctx = EngineContext(T, ta_chunk=chunk, prefix_depth=40, device="cpu")
    for regime in ("every_sign", "sparse_non_negative"):
        U = _batches(rng)[regime]
        want = ref_get_engine("ta").run(ref_ctx, jnp.asarray(U), K,
                                        budget=budget)
        got = get_engine("ta").run(ctx, U, K, budget=budget)
        _assert_same(got, want)
        depth = host(got.depth)
        assert (depth <= budget).all(), regime
        if budget < 100:
            # the deep lanes halt at the budget, their bound kept finite
            halted = depth == budget
            assert halted.any(), regime
            assert np.isfinite(host(got.upper)[halted]).all(), regime
    # the context's own round cap, tightened by the budget
    halted = get_engine("ta").run(
        EngineContext(T, ta_chunk=chunk, prefix_depth=40, max_blocks=30,
                      device="cpu"), U, K, budget=budget)
    _assert_same(halted, ref_get_engine("ta").run(
        RefContext(jnp.asarray(T), ta_chunk=chunk, prefix_depth=40,
                   max_blocks=30), jnp.asarray(U), K, budget=budget))
    assert (host(halted.depth) <= min(30, budget)).all()


def test_k_past_the_catalogue_pads_like_naive():
    T = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    U = np.ones((2, 4), np.float32)
    for prefix_depth in (0, 4):
        ctx = EngineContext(T, ta_chunk=2, prefix_depth=prefix_depth,
                            device="cpu")
        got = get_engine("ta").run(ctx, U, 7)
        want = get_engine("naive").run(ctx, U, 7)
        assert got.values.shape == want.values.shape == (2, 7)
        with np.errstate(invalid="ignore"):  # gaps between -inf pad slots
            assert_topk_equal((got.values, got.indices),
                              (want.values, want.indices))


# ---------------------------------------------------------------------------
# The TA entry points against their reference counterparts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_rounds", [-1, 13])
def test_threshold_topk_entry_points_match_reference(max_rounds):
    rng = np.random.default_rng(53)
    T = rng.standard_normal((300, R)).astype(np.float32)
    ref_idx, idx = _index_arrays(T)
    ref_lay = ref_build_list_major(T, ref_idx, prefix_depth=24)
    lay = build_list_major(T, idx, prefix_depth=24)
    Tt = torch.from_numpy(T)
    od = host(idx.order_desc)
    for regime, U in _some_batches(rng).items():
        for u in U[:1]:
            want = ref_threshold_from_index(jnp.asarray(T), ref_idx,
                                            jnp.asarray(u), K, max_rounds)
            got = threshold_topk_from_index(Tt, idx, torch.from_numpy(u), K,
                                            max_rounds)
            _assert_same(got, want)
            # without rank_desc: ranks worked out from order_desc
            _assert_same(threshold_topk(Tt, idx.order_desc,
                                        idx.t_sorted_desc,
                                        torch.from_numpy(u), K, max_rounds),
                         want)
        for chunk, layout in ((1, None), (1, "layout"), (8, "layout")):
            want = ref_threshold_batched(
                jnp.asarray(T), ref_idx, jnp.asarray(U), K, chunk=chunk,
                max_rounds=max_rounds,
                layout=ref_lay if layout else None)
            got = threshold_topk_batched_from_index(
                Tt, idx, torch.from_numpy(U), K, chunk=chunk,
                max_rounds=max_rounds, layout=lay if layout else None)
            _assert_same(got, want)
            if max_rounds < 0:
                _assert_oracle(got, T, od, U)


@pytest.mark.parametrize("max_rounds", [-1, 29])
def test_chunked_ta_topk_entry_points_match_reference(max_rounds):
    rng = np.random.default_rng(59)
    T = rng.standard_normal((300, R)).astype(np.float32)
    ref_idx, idx = _index_arrays(T)
    ref_lay = ref_build_list_major(T, ref_idx, prefix_depth=24)
    lay = build_list_major(T, idx, prefix_depth=24)
    Tt = torch.from_numpy(T)
    for chunk in (1, 8):
        for regime, U in _some_batches(rng).items():
            for layout in (None, "layout"):
                for u in U[:1]:
                    want = ref_chunked_ta_topk(
                        jnp.asarray(T), ref_idx.order_desc,
                        ref_idx.t_sorted_desc, ref_idx.rank_desc,
                        jnp.asarray(u), K, chunk=chunk,
                        max_rounds=max_rounds,
                        layout=ref_lay if layout else None)
                    got = chunked_ta_topk(
                        Tt, idx.order_desc, idx.t_sorted_desc,
                        idx.rank_desc, torch.from_numpy(u), K, chunk=chunk,
                        max_rounds=max_rounds,
                        layout=lay if layout else None)
                    _assert_same(got, want)
            want = ref_chunked_ta_topk_batched(
                jnp.asarray(T), ref_idx, jnp.asarray(U), K, chunk=chunk,
                max_rounds=max_rounds)
            got = chunked_ta_topk_batched(Tt, idx, torch.from_numpy(U), K,
                                          chunk=chunk, max_rounds=max_rounds)
            _assert_same(got, want)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


def test_server_serves_ta_and_threshold_like_the_reference():
    rng = np.random.default_rng(61)
    T = rng.standard_normal((700, 12)).astype(np.float32)
    ref = RefServer(RefModel(jnp.asarray(T)), max_batch=16)
    srv = TopKServer(from_reference({"targets": T}, device="cpu"),
                     max_batch=16, device="cpu")
    U = np.concatenate([_batches(rng, r=12)["every_sign"]] * 5)  # 2 chunks
    for method in ("ta", "threshold"):
        for budget in (None, 20):
            want = ref.query(jnp.asarray(U), 8, method=method, budget=budget)
            got = srv.query(U, 8, method=method, budget=budget)
            assert isinstance(got.values, np.ndarray)
            assert got.values.shape == (20, 8)
            _assert_same(got, want)
    a, b = srv.stats["ta"], ref.stats["ta"]
    assert (a.n_queries, a.n_scored, a.depth_sum) == (
        b.n_queries, b.n_scored, b.depth_sum)
    assert a.sign_batches == b.sign_batches == {"unbucketed": 8}
