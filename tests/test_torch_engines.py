"""Parity of the port's scans, engine registry and server with the JAX
reference, on the CPU (the kernel engine runs its plain PyTorch version).

The reference's kernel engine is ``pallas``; the port registers it as
``topk_mips`` with the alias ``pallas``, so stats keyed by engine name are
mapped one to the other. The reference server is queried cold: its
``warmup`` compiles every batch bucket and the streaming tail, which takes
minutes on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import random_model as ref_random_model
from repro.core.blocked import norm_pruned_topk as ref_norm_pruned_topk
from repro.core.blocked import \
    norm_pruned_topk_batched as ref_norm_pruned_topk_batched
from repro.core.driver import merge_topk_sorted as ref_merge_topk_sorted
from repro.core.engines import EngineContext as RefContext
from repro.core.engines import get_engine as ref_get_engine
from repro.serving.server import TopKServer as RefServer
from repro_torch.convert import INDEX_FIELDS, from_reference
from repro_torch.core.blocked import (norm_pruned_topk,
                                      norm_pruned_topk_batched)
from repro_torch.core.driver import merge_topk_sorted
from repro_torch.core.engines import (CostTable, EngineContext, batch_bucket,
                                      engine_names, get_engine, list_engines,
                                      m_bucket, pad_to_bucket)
from repro_torch.kernels.topk_mips import topk_mips
from repro_torch.serving.server import (ServeStats, TopKServer,
                                        TwoStageRanker)

from _torch_parity import assert_topk_equal, host

ROOT = Path(__file__).resolve().parents[1]
REF_NAME = {"naive": "naive", "norm": "norm", "topk_mips": "pallas",
            "bta": "bta"}


def _norm_arrays(T: np.ndarray, bucket: int):
    """Norm-major arrays padded to ``bucket`` (zero rows, norm 0, id -1)."""
    norms = np.linalg.norm(T, axis=1)
    order = np.argsort(-norms, kind="stable").astype(np.int32)
    pad = bucket - T.shape[0]
    tbn = np.concatenate([T[order], np.zeros((pad, T.shape[1]), np.float32)])
    return (tbn, np.concatenate([order, np.full(pad, -1, np.int32)]),
            np.concatenate([norms[order], np.zeros(pad, np.float32)]))


def _assert_result(got, want):
    assert_topk_equal((got.values, got.indices), (want.values, want.indices))
    for f in ("n_scored", "depth"):
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    # upper is ||u|| * a norm: one rounding of the query norm apart
    np.testing.assert_allclose(host(got.upper), np.asarray(want.upper),
                               rtol=1e-6)


@pytest.mark.parametrize("max_blocks", [1, 3, -1])
@pytest.mark.parametrize("m", [255, 256, 257])
def test_norm_scan_matches_reference_through_m_bucket(m, max_blocks):
    rng = np.random.default_rng(m)
    T = (rng.standard_normal((m, 8))
         * np.linspace(2.0, 0.2, m)[:, None]).astype(np.float32)
    U = rng.standard_normal((4, 8)).astype(np.float32)
    tbn, order, norms = _norm_arrays(T, m_bucket(m))
    want = ref_norm_pruned_topk_batched(
        jnp.asarray(tbn), jnp.asarray(order), jnp.asarray(norms),
        jnp.asarray(U), 5, 64, max_blocks, m_real=jnp.int32(m))
    got = norm_pruned_topk_batched(
        torch.from_numpy(tbn), torch.from_numpy(order),
        torch.from_numpy(norms), torch.from_numpy(U), 5, 64, max_blocks,
        m_real=m)
    _assert_result(got, want)


@pytest.mark.parametrize("m,block", [(600, 64), (40, 64)])
def test_single_query_norm_scan_matches_reference(m, block):
    rng = np.random.default_rng(m)
    T = rng.standard_normal((m, 6)).astype(np.float32)
    u = rng.standard_normal(6).astype(np.float32)
    tbn, order, norms = _norm_arrays(T, m)
    want = ref_norm_pruned_topk(
        jnp.asarray(T), jnp.asarray(order), jnp.asarray(norms),
        jnp.asarray(u), 4, block, targets_by_norm=jnp.asarray(tbn))
    got = norm_pruned_topk(
        torch.from_numpy(T), torch.from_numpy(order), torch.from_numpy(norms),
        torch.from_numpy(u), 4, block, targets_by_norm=torch.from_numpy(tbn))
    _assert_result(got, want)


def test_merge_topk_sorted_carry_wins_ties():
    a_vals = np.array([5.0, 3.0, 3.0, 1.0], np.float32)
    b_vals = np.array([4.0, 3.0, 1.0, -np.inf], np.float32)
    a_ids = np.array([0, 1, 2, 3], np.int32)
    b_ids = np.array([10, 11, 12, -1], np.int32)
    want = ref_merge_topk_sorted(jnp.asarray(a_vals), jnp.asarray(a_ids),
                                 jnp.asarray(b_vals), jnp.asarray(b_ids), 6)
    got = merge_topk_sorted(*map(torch.from_numpy,
                                 (a_vals, a_ids, b_vals, b_ids)), 6)
    np.testing.assert_array_equal(host(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(host(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(host(got[1]), [0, 10, 1, 2, 11, 3])


def test_registry_names_and_aliases():
    assert engine_names() == ["auto", "bta", "fagin", "naive", "norm",
                              "norm_sharded", "partial", "ta", "topk_mips"]
    assert [e.name for e in list_engines() if e.has_executable] == [
        "bta", "naive", "norm", "norm_sharded", "ta", "topk_mips"]
    assert get_engine("pallas").name == "topk_mips"
    assert get_engine("threshold").name == "ta"
    assert get_engine("ta").layout == "list_major"
    assert get_engine("norm_pruned").name == "norm"
    assert get_engine("blocked").name == "bta"
    assert get_engine("bta").layout == "list_major"
    assert [e.name for e in list_engines(backend="cuda")] == ["topk_mips"]
    assert [e.name for e in list_engines(needs_index=False)] == ["naive"]
    assert {e.name for e in list_engines() if e.supports_budget} == {
        "auto", "bta", "naive", "norm", "ta"}
    assert [e.name for e in list_engines(backend="numpy")] == [
        "fagin", "partial"]
    assert get_engine("norm_sharded").layout == "norm_sharded"
    with pytest.raises(ValueError, match=r"registered: \['auto', 'bta', "
                                         r"'fagin', 'naive', 'norm', "
                                         r"'norm_sharded', 'partial', 'ta', "
                                         r"'topk_mips'\]"):
        get_engine("norm_shard")


def test_engines_run_on_a_carried_index():
    """An EngineContext over the reference's own index, through
    from_reference, serves what the reference's context serves."""
    rng = np.random.default_rng(8)
    T = rng.standard_normal((333, 8)).astype(np.float32)
    U = rng.standard_normal((5, 8)).astype(np.float32)
    ref_ctx = RefContext(jnp.asarray(T), block_size=64)
    idx = from_reference({f: np.asarray(getattr(ref_ctx.index, f))
                          for f in INDEX_FIELDS}, device="cpu")
    ctx = EngineContext(T, index=idx, block_size=64, device="cpu")
    assert ctx.layout("norm_major").targets_by_norm is idx.targets_by_norm
    for name in ("naive", "norm", "pallas", "bta"):
        _assert_result(get_engine(name).run(ctx, U, 5),
                       ref_get_engine(name).run(ref_ctx, jnp.asarray(U), 5))


def test_buckets_pad_by_repeating_the_last_query():
    assert [batch_bucket(n) for n in (1, 2, 3, 64, 65)] == [1, 2, 4, 64, 128]
    assert m_bucket(325056) == 524288
    U = torch.arange(6.0).reshape(3, 2)
    P = pad_to_bucket(U)
    assert P.shape == (4, 2) and torch.equal(P[3], U[2])
    assert pad_to_bucket(U[:2]).shape[0] == 2


@pytest.fixture(scope="module")
def servers():
    rng = np.random.default_rng(21)
    ref_model = ref_random_model(rng, 1500, 16, "lowrank_spectrum")
    model = from_reference({"targets": np.asarray(ref_model.targets)},
                           device="cpu")
    spectrum = (1.0 / np.sqrt(1.0 + np.arange(16))).astype(np.float32)
    U = rng.standard_normal((40, 16)).astype(np.float32) * spectrum
    return (RefServer(ref_model, max_batch=16, block_size=64),
            TopKServer(model, max_batch=16, block_size=64, device="cpu"), U)


@pytest.mark.parametrize("method", ["naive", "norm", "topk_mips", "bta"])
def test_server_matches_reference_server(servers, method):
    """40 queries through max_batch=16: three chunks, the last partial."""
    ref, srv, U = servers
    want = ref.query(jnp.asarray(U), 10, method=REF_NAME[method])
    got = srv.query(U, 10, method=method)
    assert isinstance(got.values, np.ndarray) and got.values.shape == (40, 10)
    _assert_result(got, want)
    a, b = srv.stats[method], ref.stats[REF_NAME[method]]
    assert (a.n_queries, a.n_scored, a.depth_sum) == (
        b.n_queries, b.n_scored, b.depth_sum)
    assert a.sign_batches == b.sign_batches
    assert len(a.lat_us_ring) == 3 and a.us_per_query > 0


def test_server_alias_and_budget_match_reference(servers):
    ref, srv, U = servers
    got = srv.query(U[:8], 10, method="pallas")
    _assert_result(got, ref.query(jnp.asarray(U[:8]), 10, method="pallas"))
    got = srv.query(U[:8], 10, method="norm", budget=100)
    _assert_result(got, ref.query(jnp.asarray(U[:8]), 10, method="norm",
                                  budget=100))
    with pytest.raises(ValueError, match="does not support budgeted"):
        srv.query(U[:2], 10, method="topk_mips", budget=100)


def test_server_validation_and_later_slices(servers):
    _, srv, U = servers
    # the sharded norm scan (a 1-device mesh here) serves by name
    np.testing.assert_array_equal(
        srv.query(U[:8], 5, method="norm_sharded").values,
        srv.query(U[:8], 5, method="norm").values)
    with pytest.raises(ValueError, match="unknown engine 'norm_shard'"):
        srv.query(U, 5, method="norm_shard")
    with pytest.raises(ValueError, match="k must be"):
        srv.query(U, 0, method="naive")
    with pytest.raises(ValueError, match="budget must be"):
        srv.query(U, 5, method="norm", budget=0)
    with pytest.raises(ValueError, match="query rank"):
        srv.query(U[:, :3], 5, method="naive")
    bad = U[:3].copy()
    bad[1, 0] = np.nan
    with pytest.raises(ValueError, match="row 1"):
        srv.query(bad, 5, method="naive")
    with pytest.raises(ValueError, match="deadline_ms must be"):
        srv.query(U, 5, method="naive", deadline_ms=-1.0)
    # the streaming tier's mutations serve (servers of their own: the
    # fixture's stays static), single-level and over the LSM ladder
    for n_shards in (0, 2):
        mut = TopKServer(srv.model, max_batch=16, block_size=64,
                         n_shards=n_shards, device="cpu")
        assert mut.catalogue.n_shards == n_shards
        new = mut.add_targets(U[:1])
        mut.delete_targets([0])
        mut.update_targets([1], U[1:2])
        assert mut.mutation_stats["num_live"] == srv.ctx.num_targets
        assert int(new[0]) == srv.ctx.num_targets
        rows, gids = mut.catalogue.as_dense()
        best = gids[np.argmax(U[:4].astype(np.float64) @ rows.T, axis=1)]
        np.testing.assert_array_equal(
            mut.query(U[:4], 1, method="naive").indices[:, 0], best)


def test_warmup_primes_cost_table_and_counts_no_cpu_launches(tmp_path):
    model = from_reference({"targets": np.random.default_rng(1).standard_normal(
        (700, 8)).astype(np.float32)}, device="cpu")
    srv = TopKServer(model, max_batch=8, block_size=64, device="cpu")
    before = topk_mips.launches
    srv.warmup(5, batch_sizes=(1, 8))
    assert srv.available_engines() == ["auto", "bta", "fagin", "naive",
                                       "norm", "norm_sharded", "partial",
                                       "ta", "topk_mips"]
    # the default warmup primes every executable engine, and only them
    warmed = ["bta", "naive", "norm", "norm_sharded", "ta", "topk_mips"]
    for name in warmed:
        assert srv.cost_table.predict(name, 8, "", granular_only=True) > 0
    assert {key.split("|")[0] for key in srv.cost_table.snapshot()} == set(
        warmed)
    assert topk_mips.launches == before       # CPU tensors: plain version
    path = tmp_path / "costs.json"
    srv.cost_table.save(path)
    loaded = CostTable.load(path)
    assert loaded.snapshot() == srv.cost_table.snapshot()
    assert loaded.n_observations == srv.cost_table.n_observations


def test_serve_stats_percentiles_and_two_stage_ranker(servers):
    st = ServeStats()
    for i in range(10):
        st.record_batch(2, 20, 4, 1e-3 * (i + 1))
        st.record_request_latency(float(i))
    ring = [1e3 * (i + 1) / 2 for i in range(10)]
    assert st.p95_us == pytest.approx(np.percentile(ring, 95))
    assert st.req_p50_us == pytest.approx(4.5)
    assert st.scores_per_query == 10 and st.n_queries == 20

    _, srv, U = servers
    ranker = TwoStageRanker(srv, lambda q, cand: -cand.astype(np.float64),
                            retrieve_n=20)
    ids, scores = ranker.rank({}, U[:3], 5, method="naive")
    full = srv.query(U[:3], 20, method="naive").indices
    np.testing.assert_array_equal(ids, np.sort(full, axis=1)[:, :5])


def test_serve_cli_sweeps_every_engine_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--engine", "all", "--targets", "2000", "--rank", "16", "-n", "30",
         "--batch", "16", "--k", "5"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("bta", "naive", "norm", "topk_mips"):
        assert f"{name}:" in out.stdout
