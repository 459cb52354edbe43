"""Parity of the port's ``auto`` router with the JAX reference, on the CPU:
``select_engine``'s cold and measured routes, ``cost_label``,
``auto_candidates``, the cost table (``engine_cost``, save/load, the key
set a warmup primes), ``query(U, k, "auto")`` through both servers, every
engine's traffic estimate, and the serve CLI's ``all`` and ``auto`` sweeps.

A context on the CPU routes as the reference does off the TPU: its norm
scan is ``norm`` (``topk_mips`` is the card's). The reference's kernel
engine is ``pallas``, the port's ``topk_mips``."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CostTable as RefCostTable
from repro.core import SepLRModel as RefSepLRModel
from repro.core.engines import EngineContext as RefContext
from repro.core.engines import auto_candidates as ref_auto_candidates
from repro.core.engines import cost_label as ref_cost_label
from repro.core.engines import get_engine as ref_get_engine
from repro.core.engines import select_engine as ref_select_engine
from repro.serving.server import TopKServer as RefServer
from repro_torch.core import CostTable, SepLRModel, select_engine
from repro_torch.core.engines import (BATCHED_LIST_MIN_B, EngineContext,
                                      auto_candidates, batch_bucket,
                                      cost_label, get_engine)
from repro_torch.serving.server import TopKServer

from _torch_parity import host

ROOT = Path(__file__).resolve().parents[1]
REF_NAME = {"topk_mips": "pallas"}
# two fp32 summation orders (XLA:CPU and PyTorch's CPU GEMM)
RTOL, ATOL = 1e-5, 1e-4


def assert_values(got, want):
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _ref(name: str) -> str:
    return REF_NAME.get(name, name)


def _sparse(b: int, r: int) -> np.ndarray:
    U = np.zeros((b, r), np.float32)
    U[:, :3] = 1.0
    return U


def _scenarios():
    """The reference's four ``auto`` tests (tests/test_engines.py) as
    (context kwargs, targets, queries) cases, one pick each."""
    rng = np.random.default_rng(0)
    flat24 = rng.standard_normal((500, 24)).astype(np.float32)
    decay = rng.standard_normal((2000, 16)).astype(np.float32)
    decay *= (1.0 / np.sqrt(1.0 + np.arange(2000)))[:, None]
    flat16 = rng.standard_normal((1000, 16)).astype(np.float32)
    U16 = rng.standard_normal((8, 16)).astype(np.float32)
    return {
        "sparse": ({}, flat24, _sparse(4, 24)),
        "decaying": ({}, decay, U16[:4]),
        "flat_b8_prefix": ({"prefix_depth": 64}, flat16, U16),
        "flat_b2_prefix": ({"prefix_depth": 64}, flat16, U16[:2]),
        "flat_b8_layout_off": ({"prefix_depth": 0}, flat16, U16),
        "sparse_b8_prefix": ({"prefix_depth": 64}, flat24, _sparse(8, 24)),
        "sparse_b2_prefix": ({"prefix_depth": 64}, flat24, _sparse(2, 24)),
    }


SCENARIOS = _scenarios()
WANT = {"sparse": "ta", "decaying": "norm", "flat_b8_prefix": "bta",
        "flat_b2_prefix": "norm", "flat_b8_layout_off": "norm",
        "sparse_b8_prefix": "ta", "sparse_b2_prefix": "norm"}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_cold_route_picks_what_the_reference_picks(case):
    kw, T, U = SCENARIOS[case]
    ctx = EngineContext(T, device="cpu", **kw)
    ref = RefContext(jnp.asarray(T), **kw)
    got = select_engine(ctx, U).name
    assert got == ref_select_engine(ref, jnp.asarray(U)).name == WANT[case]
    # a tensor batch routes as its host copy does
    assert select_engine(ctx, ctx.targets.new_tensor(U)).name == got
    assert ctx.norm_decay == pytest.approx(ref.norm_decay, rel=1e-6)


def test_cold_route_sends_the_card_to_topk_mips():
    """The norm-scan route depends on the context's device: a context
    claiming ``cuda`` (no card needed to route) gets the kernel engine
    where the CPU context gets ``norm``; the other routes agree."""
    for case, (kw, T, U) in SCENARIOS.items():
        ctx = EngineContext(T, device="cpu", **kw)
        want = select_engine(ctx, U).name
        # routing reads no tensor on the context's device
        ctx.device = torch.device("cuda")
        got = select_engine(ctx, U).name
        assert got == ("topk_mips" if want == "norm" else want), case


def test_auto_candidates_by_device():
    assert auto_candidates("cpu") == ref_auto_candidates() == [
        "ta", "bta", "naive", "norm"]
    assert auto_candidates("cuda") == auto_candidates() == [
        "ta", "bta", "naive", "topk_mips"]
    assert BATCHED_LIST_MIN_B == 8


@pytest.mark.parametrize("prefix", [0, 64])
def test_cost_label_strings_match_the_reference(prefix):
    rng = np.random.default_rng(4)
    T = rng.standard_normal((300, 12)).astype(np.float32)
    ctx = EngineContext(T, prefix_depth=prefix, device="cpu")
    ref = RefContext(jnp.asarray(T), prefix_depth=prefix)
    dense = rng.standard_normal((5, 12)).astype(np.float32)
    batches = [np.abs(dense), -np.abs(dense), dense, _sparse(5, 12),
               -_sparse(5, 12)]
    labels = set()
    for name in ("naive", "ta", "bta", "norm", "topk_mips"):
        for U in batches:
            got = cost_label(get_engine(name), ctx, U)
            assert got == ref_cost_label(ref_get_engine(_ref(name)), ref,
                                         jnp.asarray(U))
            labels.add(got)
    want = {""} if prefix == 0 else {
        "", "nonneg-dense", "nonpos-dense", "mixed-sparse",
        "nonneg-sparse", "nonpos-sparse"}
    assert labels == want


def test_measured_route_picks_the_cheapest_of_the_same_table():
    """Both routers over tables filled alike: the measured pick, the
    fall-back to the cold route while a candidate is unmeasured, and the
    explicit table overriding the context's."""
    rng = np.random.default_rng(3)
    T = rng.standard_normal((521, 18)).astype(np.float32)
    U = rng.standard_normal((8, 18)).astype(np.float32)
    bucket = batch_bucket(8)
    ct, ref_ct = CostTable(), RefCostTable()
    ctx = EngineContext(T, cost_table=ct, device="cpu")
    ref = RefContext(jnp.asarray(T), cost_table=ref_ct)
    cold = select_engine(ctx, U).name
    assert cold == ref_select_engine(ref, jnp.asarray(U)).name
    for cheap in auto_candidates("cpu"):
        for name in auto_candidates("cpu"):
            cost = 1e-9 if name == cheap else 1.0 + len(name)
            ct.observe(name, bucket,
                       cost_label(get_engine(name), ctx, U), cost)
            ref_ct.observe(name, bucket,
                           ref_cost_label(ref_get_engine(name), ref,
                                          jnp.asarray(U)), cost)
        # the EWMA pulls the newest cheap entry below the rest
        for _ in range(40):
            ct.observe(cheap, bucket,
                       cost_label(get_engine(cheap), ctx, U), 1e-9)
            ref_ct.observe(cheap, bucket,
                           ref_cost_label(ref_get_engine(cheap), ref,
                                          jnp.asarray(U)), 1e-9)
        assert select_engine(ctx, U).name == cheap
        assert ref_select_engine(ref, jnp.asarray(U)).name == cheap
    partial, ref_partial = CostTable(), RefCostTable()
    first = auto_candidates("cpu")[0]
    partial.observe(first, bucket, cost_label(get_engine(first), ctx, U),
                    1e-9)
    ref_partial.observe(first, bucket,
                        ref_cost_label(ref_get_engine(first), ref,
                                       jnp.asarray(U)), 1e-9)
    ctx2 = EngineContext(T, cost_table=partial, device="cpu")
    ref2 = RefContext(jnp.asarray(T), cost_table=ref_partial)
    assert select_engine(ctx2, U).name == cold
    assert ref_select_engine(ref2, jnp.asarray(U)).name == cold
    assert select_engine(ctx2, U, cost_table=ct).name == \
        ref_select_engine(ref2, jnp.asarray(U), cost_table=ref_ct).name


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_loaded_cost_table_routes_before_any_measurement(tmp_path,
                                                         saved_by):
    """A table measured in another process routes ``auto`` from disk
    before this server observes anything — whichever package saved it
    (the two share the file format)."""
    rng = np.random.default_rng(91)
    T = rng.standard_normal((120, 8)).astype(np.float32)
    U = rng.standard_normal((1, 8)).astype(np.float32)
    probe = EngineContext(T, block_size=16, device="cpu")
    prev = CostTable() if saved_by == "port" else RefCostTable()
    for i, name in enumerate(auto_candidates("cpu")):
        lbl = cost_label(get_engine(name), probe, U)
        prev.observe(name, batch_bucket(1), lbl,
                     1e-5 if name == "ta" else (i + 2) * 1e-3)
    path = tmp_path / "costs.json"
    prev.save(path)
    loaded = CostTable.load(path)
    srv = TopKServer(SepLRModel(T, device="cpu"), block_size=16,
                     cost_table=loaded, device="cpu")
    assert srv.cost_table is loaded and srv.ctx.cost_table is loaded
    assert loaded.n_observations == len(auto_candidates("cpu"))
    assert select_engine(srv.ctx, U).name == "ta"   # not the cold pick
    assert select_engine(probe, U).name == "norm"
    ref_srv = RefServer(RefSepLRModel(jnp.asarray(T)), block_size=16,
                        delta_capacity=8, cost_table=RefCostTable.load(path))
    assert ref_select_engine(ref_srv.ctx, U).name == "ta"


def test_engine_cost_and_save_load_roundtrip(tmp_path):
    for cls in (CostTable, RefCostTable):
        t = cls(alpha=0.3)
        t.observe("norm", 1, "", 2e-4)
        t.observe("norm", 1, "", 1e-4)
        t.observe("ta", 64, "POS:5", 3e-4)
        path = tmp_path / f"{cls.__module__}.json"
        t.save(path)
        t2 = CostTable.load(path)
        assert t2.alpha == t.alpha
        assert t2.n_observations == t.n_observations == 3
        assert t2.snapshot() == t.snapshot()
        assert t2.predict("ta", 64, "POS:5") == t.predict("ta", 64, "POS:5")
        assert t2.engine_cost("norm") == t.engine_cost("norm") \
            == pytest.approx(0.7 * 2e-4 + 0.3 * 1e-4)
        assert t2.engine_cost("never-ran") is None
        before = t2.predict("norm", 1, "")
        t2.observe("norm", 1, "", 9e-4)
        assert t2.predict("norm", 1, "") != before


@pytest.mark.parametrize("prefix", [0, 64])
def test_warmup_primes_the_reference_key_set(prefix):
    """The same warmup (sizes 1 and 8, budget 16, four engines) primes the
    same (engine, bucket, label) keys in both tables: one per sign bucket
    for the list engines with the layout on, budgeted runs under
    ``"<name>@budget"``."""
    rng = np.random.default_rng(60 + prefix)
    T = rng.standard_normal((301, 10)).astype(np.float32)
    engines = ["naive", "ta", "bta", "norm"]
    ct, ref_ct = CostTable(), RefCostTable()
    EngineContext(T, block_size=16, prefix_depth=prefix,
                  device="cpu").warmup(5, batch_sizes=(1, 8), budgets=(16,),
                                       engines=engines, cost_table=ct)
    RefContext(jnp.asarray(T), block_size=16, prefix_depth=prefix).warmup(
        5, batch_sizes=(1, 8), budgets=(16,), engines=engines,
        cost_table=ref_ct)
    keys = set(ct.snapshot())
    assert keys == set(ref_ct.snapshot())
    assert ct.n_observations == ref_ct.n_observations == len(keys)
    signs = 1 if prefix == 0 else 4
    assert len(keys) == 2 * (2 * 2 + 2 * 2 * signs)
    assert "bta@budget|8|mixed-sparse" in keys or prefix == 0


def test_warmup_skips_dispatch_engines_and_refuses_them_by_name():
    ctx = EngineContext(np.eye(4, dtype=np.float32), device="cpu")
    ct = CostTable()
    ctx.warmup(2, batch_sizes=(1,), cost_table=ct)
    assert {key.split("|")[0] for key in ct.snapshot()} == {
        "bta", "naive", "norm", "norm_sharded", "ta", "topk_mips"}
    for name in ("auto", "fagin", "partial"):
        assert not get_engine(name).has_executable
        with pytest.raises(ValueError, match="dispatch-only"):
            ctx.warmup(2, batch_sizes=(1,), engines=[name])


@pytest.fixture(scope="module")
def servers():
    rng = np.random.default_rng(23)
    T = rng.standard_normal((900, 16)).astype(np.float32)
    U = rng.standard_normal((40, 16)).astype(np.float32)
    U[16:32] = 0.0
    U[16:32, :2] = 1.0          # the second chunk is sparse
    return (RefServer(RefSepLRModel(jnp.asarray(T)), max_batch=16,
                      block_size=64),
            TopKServer(SepLRModel(T, device="cpu"), max_batch=16,
                       block_size=64, device="cpu"), U)


def test_server_auto_matches_reference_server(servers):
    """Three chunks, cold routes: dense chunks to ``norm``, the sparse one
    to ``ta``; values, ids, counts and per-engine stats equal."""
    ref, srv, U = servers
    want = ref.query(jnp.asarray(U), 10, method="auto")
    got = srv.query(U, 10, method="auto")
    assert_values(got.values, want.values)
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    for f in ("n_scored", "depth"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    # ta's bound is a sum of R products: a few ulps apart
    np.testing.assert_allclose(got.upper, np.asarray(want.upper), rtol=1e-5)
    ran = {name: st.n_queries for name, st in srv.stats.items()}
    assert ran == {name: st.n_queries for name, st in ref.stats.items()} \
        == {"auto": 0, "norm": 24, "ta": 16}
    assert len(srv.stats["auto"].req_lat_us_ring) == 1
    # a tensor batch routes and serves alike
    again = srv.query(srv.ctx.targets.new_tensor(U), 10, method="auto")
    np.testing.assert_array_equal(again.indices, got.indices)


def test_auto_engine_runs_and_budgets_like_the_reference(servers):
    ref, srv, U = servers
    for budget in (None, 64):
        want = ref_get_engine("auto").run(ref.ctx, jnp.asarray(U[:8]), 5,
                                          budget=budget)
        got = get_engine("auto").run(srv.ctx, U[:8], 5, budget=budget)
        assert_values(got.values, want.values)
        np.testing.assert_array_equal(host(got.indices),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(host(got.n_scored),
                                      np.asarray(want.n_scored))


@pytest.mark.parametrize("prefix", [0, 64])
@pytest.mark.parametrize("name", ["naive", "ta", "bta", "norm", "topk_mips",
                                  "fagin", "partial"])
def test_traffic_matches_reference(name, prefix):
    rng = np.random.default_rng(5)
    T = rng.standard_normal((400, 8)).astype(np.float32)
    U = rng.standard_normal((4, 8)).astype(np.float32)
    ctx = EngineContext(T, block_size=32, prefix_depth=prefix, device="cpu")
    ref = RefContext(jnp.asarray(T), block_size=32, prefix_depth=prefix)
    eng, ref_eng = get_engine(name), ref_get_engine(_ref(name))
    assert eng.traffic is not None
    got = eng.traffic(ctx, eng.run(ctx, U, 5))
    want = ref_eng.traffic(ref, ref_eng.run(ref, jnp.asarray(U), 5))
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def _serve_cli(engine: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--engine", engine, "--targets", "1500", "--rank", "16", "-n", "20",
         "--batch", "16", "--k", "5"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("engine", ["all", "auto"])
def test_serve_cli_skips_the_host_oracles_and_warms_auto(engine):
    out = _serve_cli(engine)
    assert "fagin" not in out and "partial" not in out
    warmed = next(line for line in out.splitlines()
                  if line.startswith("warmed:")).split()[1:]
    if engine == "all":
        assert warmed == ["naive", "bta", "norm", "norm_sharded", "ta",
                          "topk_mips"]
        for name in warmed:
            assert f"{name}:" in out
    else:
        assert warmed == sorted(auto_candidates("cpu"))
        assert "auto->" in out
