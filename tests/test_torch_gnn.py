"""The port's GNN slice against the JAX reference, on the CPU:
``configs/pna.py`` and ``GNN_SHAPES``, the graph generators
(``random_graph``, ``molecule_batch``), ``NeighborSampler`` and
``pad_subgraph`` bit for bit, ``_pna_aggregate`` (ReLU ties at 0,
duplicate messages, masked edges, padding edges to node 0, zero-degree
nodes), ``forward`` and ``loss_fn`` with every gradient leaf for the node
and graph tasks, the deterministic segment sum, ``link_scores``, three
``Trainer`` steps of ``pna-smoke``, and ``models/embedding.py:
hashed_lookup`` with its gradient.

The reference's parameters (``init_params`` with ``PRNGKey(0)``) cross to
the port through ``convert.gnn_params_from_reference``; the graphs are
made from numpy seeds by generators both packages share bit for bit.

Tolerances, normwise (``||got - want|| / ||want||``, per leaf). At fp32
the logits and the loss within ``TOL`` = 1e-5 of the reference's
(measured: 2.4e-6 and 5.1e-6 at most). Gradients within ``TOL`` or
``F32_FACTOR`` = 10 times the reference's own fp32 error (its distance
from the gradient it computes at float64), whichever is larger: the std
aggregator's ``sq / count - mean**2`` cancels, so both packages' fp32
gradients carry rounding it amplifies, and on the molecule batch the
reference's own fp32 gradient lies 2.29e-5 from its float64 one, farther
than 1e-5 from where any other summation order lands. Measured: 2.8e-6
(power-law graph, the reference's own error 1.8e-6), 2.0e-6 (padded
subgraph), 8.9e-5 (molecules: 3.9 times the reference's own). The
reference sums segments sequentially in fp32, the port in float64 rounded
once (fp32 partial sums in its doubling scan's order put the power-law
gradients 4.3e-5 from float64). At float64 (the reference under
``jax.enable_x64``) the same function to ``F64_TOL`` = 1e-6 (measured:
6.4e-8 at most; the packages then differ where both take ``log1p`` of
the fp32 degrees). ``hashed_lookup`` is a gather, a sum and a division,
equal bit for bit, its gradient within 1e-6."""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data.loader import PrefetchLoader as RefLoader
from repro.data.synthetic import molecule_batch as ref_molecule_batch
from repro.data.synthetic import random_graph as ref_random_graph
from repro.models import gnn as ref_gnn
from repro.models.common import MeshRules as RefMeshRules
from repro.models.embedding import hashed_lookup as ref_hashed_lookup
from repro.train import optimizer as ref_opt
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_arch
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.convert import gnn_params_from_reference
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import molecule_batch, random_graph
from repro_torch.kernels.embedding_bag import segment_sum, segments
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.models.common import MeshRules, count_params
from repro_torch.models.embedding import KNUTH, hashed_lookup
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

from _torch_parity import host

TOL = 1e-5
F32_FACTOR = 10
F64_TOL = 1e-6


def _normwise(got, want) -> float:
    got = np.asarray(host(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "compute_dtype"}


def _padded_graph(seed=4, n=40, max_nodes=64, max_edges=160):
    """A sampled subgraph of a power-law graph padded by ``pad_subgraph``:
    masked padding edges to node 0, padding nodes of degree 0, and the
    seed nodes supervised."""
    g = random_graph(np.random.default_rng(seed), n, 400, 8, 3)
    sampler = gnn.NeighborSampler(g["edge_src"], g["edge_dst"], n, seed=1)
    sub = sampler.sample(np.arange(8), (4, 3))
    return gnn.pad_subgraph(sub, g["nodes"], g["labels"], max_nodes,
                            max_edges)


# graphs by name: the node task on a power-law graph and on a padded
# subgraph, the graph task on a molecule batch
GRAPHS = {
    "power_law": lambda: random_graph(np.random.default_rng(0), 64, 256, 8,
                                      3),
    "padded": _padded_graph,
    "molecules": lambda: molecule_batch(np.random.default_rng(2), 8, 10, 20,
                                        14, 2),
}


def _configs(name):
    ref_cfg = ref_get_arch("pna").make_smoke_config()
    cfg = get_arch("pna").make_smoke_config()
    if name == "molecules":
        kw = dict(task="graph", d_in=14, n_classes=2)
        ref_cfg = dataclasses.replace(ref_cfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    return ref_cfg, cfg


def _reference(ref_cfg, graph, dtype="float32"):
    """The reference's ``(params, loss, metrics, logits, gradient
    leaves)`` through ``jax.value_and_grad(loss_fn)``, its fp32 parameters
    from ``PRNGKey(0)`` cast to ``dtype`` (float64 under
    ``jax.enable_x64``)."""
    params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    with jax.enable_x64(dtype == "float64"):
        jdt = jnp.dtype(dtype)
        cfg = dataclasses.replace(ref_cfg, compute_dtype=jdt)
        p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
        g = {k: (v if k == "n_graphs" else jnp.asarray(v))
             for k, v in graph.items()}
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: ref_gnn.loss_fn(p, g, cfg), has_aux=True)(p)
        logits = ref_gnn.forward(p, g, cfg)
        return (params, float(loss),
                {k: float(v) for k, v in metrics.items()},
                np.asarray(logits), [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(grads)])


def _port(cfg, params, graph):
    leaves = [x.detach().clone().requires_grad_()
              for x in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    loss, metrics = gnn.loss_fn(tree, graph, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _port_params(ref_params):
    return gnn_params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")


# ---------------------------------------------------------------------------
# configs, generators, sampler
# ---------------------------------------------------------------------------


def test_pna_configs_and_shapes_equal_the_reference():
    spec, ref = get_arch("pna"), ref_get_arch("pna")
    assert (spec.family, spec.source) == (ref.family, ref.source) == \
        ("gnn", "arXiv:2004.05718")
    assert [dataclasses.asdict(s) for s in spec.shapes] == \
        [dataclasses.asdict(s) for s in ref.shapes] == \
        [dataclasses.asdict(s) for s in GNN_SHAPES]
    for cell in spec.shapes:
        d = cell.dims
        kw = dict(d_feat=d["d_feat"], n_classes=d["n_classes"],
                  task=d.get("task", "node"))
        cfg, ref_cfg = spec.make_config(**kw), ref.make_config(**kw)
        assert _fields(cfg) == _fields(ref_cfg)
        assert cfg.param_count() == ref_cfg.param_count()
        assert cfg.compute_dtype == torch.float32
    smoke, ref_smoke = spec.make_smoke_config(), ref.make_smoke_config()
    assert _fields(smoke) == _fields(ref_smoke)
    assert smoke.param_count() == ref_smoke.param_count()
    assert (gnn.AGGREGATORS, gnn.SCALERS) == (ref_gnn.AGGREGATORS,
                                              ref_gnn.SCALERS)


def test_init_params_tree_and_specs_match_the_reference():
    cfg, ref_cfg = get_arch("pna").make_config(), \
        ref_get_arch("pna").make_config()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, ref_params)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, params))
    for got, want in zip(tree_leaves(params),
                         jax.tree_util.tree_leaves(ref_params)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert count_params(params) == cfg.param_count() == 423_682
    w = params["layers"]["upd_w"]
    # LeCun normal over the fan-in (900)
    assert abs(float(w.std()) * np.sqrt(900) - 1) < 0.02
    specs = gnn.param_specs(cfg, MeshRules())
    ref_specs = ref_gnn.param_specs(ref_cfg, RefMeshRules())
    got = jax.tree_util.tree_leaves(specs, is_leaf=lambda x:
                                    isinstance(x, tuple))
    want = jax.tree_util.tree_leaves(ref_specs, is_leaf=lambda x:
                                     type(x).__name__ == "PartitionSpec")
    assert [tuple(s) for s in want] == got


@pytest.mark.parametrize("power_law", [True, False])
def test_random_graph_is_the_reference_graph(power_law):
    args = (300, 1200, 12, 5)
    got = random_graph(np.random.default_rng(7), *args, power_law=power_law)
    want = ref_random_graph(np.random.default_rng(7), *args,
                            power_law=power_law)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_molecule_batch_is_the_reference_batch():
    got = molecule_batch(np.random.default_rng(3), 16, 30, 64, 14, 2)
    want = ref_molecule_batch(np.random.default_rng(3), 16, 30, 64, 14, 2)
    assert got.keys() == want.keys() and got["n_graphs"] == 16
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_sampler_and_padding_are_the_reference_bit_for_bit():
    g = random_graph(np.random.default_rng(5), 500, 6000, 6, 4)
    mine = gnn.NeighborSampler(g["edge_src"], g["edge_dst"], 500, seed=3)
    ref = ref_gnn.NeighborSampler(g["edge_src"], g["edge_dst"], 500, seed=3)
    np.testing.assert_array_equal(mine.src_sorted, ref.src_sorted)
    np.testing.assert_array_equal(mine.indptr, ref.indptr)
    rng = np.random.default_rng(9)
    for step in range(3):
        seeds = rng.choice(500, 32, replace=False)
        got, want = mine.sample(seeds, (15, 10)), ref.sample(seeds, (15, 10))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        # room for every node, and a cut that drops nodes and edges
        for max_nodes, max_edges in ((4096, 8192), (40, 50)):
            p = gnn.pad_subgraph(got, g["nodes"], g["labels"], max_nodes,
                                 max_edges)
            q = ref_gnn.pad_subgraph(want, g["nodes"], g["labels"],
                                     max_nodes, max_edges)
            for k in q:
                np.testing.assert_array_equal(p[k], q[k])


# ---------------------------------------------------------------------------
# the segment sum and the aggregator
# ---------------------------------------------------------------------------


def test_segment_sum_drops_ids_outside_the_segments():
    """Against ``jax.ops.segment_sum``: ids below 0 and at or past N add
    nothing (not wrapped), long runs, empty segments; the gradient is a
    gather (zero at a dropped id), against ``jax.vjp``."""
    rng = np.random.default_rng(0)
    N = 7
    ids = rng.integers(-3, N + 3, 300).astype(np.int32)
    ids[:60] = 2                                            # a long run
    data = rng.standard_normal((300, 5)).astype(np.float32)
    cot = rng.standard_normal((N, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.ops.segment_sum(
        x, jnp.asarray(ids), num_segments=N), jnp.asarray(data))
    want_grad, = vjp(jnp.asarray(cot))
    x = torch.from_numpy(data).requires_grad_()
    got = segment_sum(x, segments(torch.from_numpy(ids), N))
    got_grad, = torch.autograd.grad(got, x, torch.from_numpy(cot))
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(host(got_grad), np.asarray(want_grad))
    assert not host(got_grad)[(ids < 0) | (ids >= N)].any()
    # 1-D data, the plan reused, an empty id list
    segs = segments(torch.from_numpy(ids), N)
    ones = segment_sum(torch.ones(300), segs)
    np.testing.assert_array_equal(host(ones), np.bincount(
        ids[(ids >= 0) & (ids < N)], minlength=N).astype(np.float32))
    empty = segment_sum(torch.zeros((0, 3)),
                        segments(torch.zeros(0, dtype=torch.int32), 4))
    assert empty.shape == (4, 3) and not empty.any()


def test_pna_aggregate_matches_reference_with_ties_masks_and_padding():
    """Messages with ReLU ties at 0 and duplicate values (ties in max and
    min), masked edges, padding edges to node 0 and nodes with no edge:
    the ``[N, 12d]`` output and the messages' gradient (``jax.vjp``, the
    gradient of a tie split evenly among the tied messages)."""
    rng = np.random.default_rng(11)
    N, E, d = 12, 90, 6
    src = rng.integers(0, 8, E).astype(np.int32)
    dst = rng.integers(1, 8, E).astype(np.int32)        # nodes 8-11: none
    mask = rng.random(E) < 0.8
    dst[-10:], src[-10:], mask[-10:] = 0, 0, False          # padding
    raw = rng.standard_normal((E, d)).astype(np.float32)
    raw[::4] = raw[1::4][:len(raw[::4])]                   # duplicates
    msgs = np.maximum(raw, 0)                             # ReLU ties at 0
    deg = np.array(jax.ops.segment_sum(jnp.asarray(mask, jnp.float32),
                                         jnp.asarray(dst), num_segments=N))
    cot = rng.standard_normal((N, 12 * d)).astype(np.float32)

    def ref(m):
        return ref_gnn._pna_aggregate(m, jnp.asarray(dst), jnp.asarray(mask),
                                      N, jnp.asarray(deg), 2.5)

    want, vjp = jax.vjp(ref, jnp.asarray(msgs))
    want_grad, = vjp(jnp.asarray(cot))
    m = torch.from_numpy(msgs).requires_grad_()
    got = gnn._pna_aggregate(m, segments(torch.from_numpy(dst), N),
                             torch.from_numpy(mask), torch.from_numpy(deg),
                             2.5)
    got_grad, = torch.autograd.grad(got, m, torch.from_numpy(cot))
    assert _normwise(got, want) <= TOL
    assert _normwise(got_grad, want_grad) <= TOL
    # the empty nodes' max and min are 0, their std sqrt(1e-5)
    out = host(got)
    np.testing.assert_array_equal(out[8:, d:3 * d], 0)
    np.testing.assert_allclose(out[8:, 3 * d:4 * d], np.sqrt(1e-5),
                               rtol=1e-6)
    # a masked message gets no gradient
    assert not host(got_grad)[~mask].any()


# ---------------------------------------------------------------------------
# forward, loss_fn and every gradient leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_forward_loss_and_gradient_match_reference(name):
    """At fp32: the logits and the loss within ``TOL`` of the reference's,
    every gradient leaf within ``TOL`` or ``F32_FACTOR`` times the
    reference's own fp32 error (its distance from its float64 gradient),
    whichever is larger; the accuracy equal. At float64 (the reference
    under ``jax.enable_x64``): the logits, the loss and every gradient
    leaf within ``F64_TOL``."""
    ref_cfg, cfg = _configs(name)
    graph = GRAPHS[name]()
    ref_params, loss, metrics, logits, grads = _reference(ref_cfg, graph)
    *_, loss64, _, logits64, grads64 = _reference(ref_cfg, graph, "float64")
    params = _port_params(ref_params)
    assert _normwise(gnn.forward(params, graph, cfg), logits) <= TOL
    got_loss, got_metrics, got_grads = _port(cfg, params, graph)
    assert abs(float(got_loss) - loss) <= TOL * abs(loss)
    assert float(got_metrics["acc"]) == metrics["acc"]
    assert float(got_metrics["xent"]) == float(got_loss)
    assert len(got_grads) == len(grads)
    for g, w, w64 in zip(got_grads, grads, grads64):
        assert g.shape == w.shape
        assert _normwise(g, w) <= max(TOL, F32_FACTOR * _normwise(w, w64))
    cfg64 = dataclasses.replace(cfg, compute_dtype=torch.float64)
    params64 = tree_map(lambda x: x.double(), params)
    graph64 = dict(graph, nodes=graph["nodes"].astype(np.float64))
    assert _normwise(gnn.forward(params64, graph64, cfg64), logits64) <= \
        F64_TOL
    got_loss, _, got_grads = _port(cfg64, params64, graph64)
    assert abs(float(got_loss) - loss64) <= F64_TOL * abs(loss64)
    for g, w64 in zip(got_grads, grads64):
        assert g.dtype == torch.float64
        assert _normwise(g, w64) <= F64_TOL


def test_graph_task_reads_n_graphs_or_the_largest_id():
    """Without ``n_graphs`` the readout takes ``max(graph_ids) + 1``
    graphs, as the reference's does; with it, the given count (a trailing
    empty graph pools to the bias)."""
    _, cfg = _configs("molecules")
    graph = GRAPHS["molecules"]()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    with_n = gnn.forward(params, graph, cfg)
    without = gnn.forward(params, {k: v for k, v in graph.items()
                                   if k != "n_graphs"}, cfg)
    assert with_n.shape == (8, 2) and torch.equal(with_n, without)
    more = gnn.forward(params, dict(graph, n_graphs=9), cfg)
    assert torch.equal(more[:8], with_n)
    assert torch.equal(more[8], params["dec_b"])


def test_two_cpu_backward_passes_are_bitwise_equal():
    _, cfg = _configs("padded")
    graph = GRAPHS["padded"]()
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a, b = _port(cfg, params, graph), _port(cfg, params, graph)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


def test_link_scores_match_reference():
    rng = np.random.default_rng(8)
    h = rng.standard_normal((30, 16)).astype(np.float32)
    q = np.array([0, 5, 29, -1, 5], np.int32)
    want = ref_gnn.link_scores({}, jnp.asarray(h), jnp.asarray(q))
    got = gnn.link_scores({}, torch.from_numpy(h), torch.from_numpy(q))
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_three_trainer_steps_track_the_reference():
    """``pna-smoke`` from the reference's parameters, the same three
    power-law graphs through both packages' ``Trainer``: the losses within
    1e-5 relative, every parameter within 1e-4 of the largest (Adam's
    first steps move an entry by about ``lr`` whatever its gradient's
    size, as ``tests/test_torch_train.py`` says)."""
    ref_cfg, cfg = _configs("power_law")
    ref_params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = _port_params(ref_params)
    kw = dict(kind="adamw", lr=3e-3, warmup_steps=1, total_steps=3)

    def graphs(make):
        def it():
            rng = np.random.default_rng(0)
            while True:
                yield make(rng, 64, 256, cfg.d_in, cfg.n_classes)
        return it

    ref_tr = RefTrainer(lambda p, b: ref_gnn.loss_fn(p, b, ref_cfg),
                        ref_params, ref_opt.OptimizerConfig(**kw),
                        RefLoader(graphs(ref_random_graph)),
                        RefTrainerConfig(total_steps=3, log_every=1))
    ref_tr.run()
    tr = Trainer(lambda p, b: gnn.loss_fn(p, b, cfg), params,
                 OptimizerConfig(**kw), PrefetchLoader(graphs(random_graph)),
                 TrainerConfig(total_steps=3, log_every=1))
    tr.run()
    got = [h["loss"] for h in tr.history]
    want = [h["loss"] for h in ref_tr.history]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_p = jax.tree_util.tree_leaves(ref_tr.params)
    scale = max(float(np.abs(np.asarray(x)).max()) for x in want_p)
    for g, w in zip(tree_leaves(tr.params), want_p):
        np.testing.assert_allclose(host(g), np.asarray(w), rtol=0,
                                   atol=1e-4 * scale)


def test_launcher_trains_pna_on_the_cpu_and_resumes(capsys):
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", "pna", "--steps", "6", "--ckpt-dir", d,
                "--ckpt-every", "3", "--device", "cpu"]
        tr = launch_train.main(args)
        assert tr.step == 6 and sorted(os.listdir(d)) == [
            "step_0000000003", "step_0000000006"]
        assert "arch=pna config=pna-smoke steps=6 loss" in \
            capsys.readouterr().out
        assert np.isfinite([h["loss"] for h in tr.history]).all()
        again = launch_train.main(args[:3] + ["10"] + args[4:])
        assert again.step == 10 and again.history[0]["step"] == 10
    # the resumed run ends where the uninterrupted one does
    whole = launch_train.main(["--arch", "pna", "--steps", "10",
                               "--device", "cpu"])
    assert whole.history[-1]["loss"] == again.history[-1]["loss"]


# ---------------------------------------------------------------------------
# hashed_lookup
# ---------------------------------------------------------------------------

EDGE_IDS = [0, -1, 1, 2 ** 31 - 1, -(2 ** 31) + 1, -(2 ** 31), 12345,
            -98765]


@pytest.mark.parametrize("num_hashes", [1, 2, 3])
def test_hashed_lookup_and_gradient_match_reference(num_hashes):
    """V = 997 (not a power of two); ids at 0, -1, +-(2**31 - 1), -2**31
    and spread over the int32 range: the rows bit for bit, the table's
    gradient (``jax.vjp``) within 1e-6."""
    rng = np.random.default_rng(num_hashes)
    V, d = 997, 5
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(-2 ** 31, 2 ** 31, (6, 40), dtype=np.int64)
    ids = ids.astype(np.int32)
    ids[0, :len(EDGE_IDS)] = EDGE_IDS
    ids[1, :20] = 77                                       # repeats
    cot = rng.standard_normal((6, 40, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: ref_hashed_lookup(t, jnp.asarray(ids),
                                                     num_hashes),
                        jnp.asarray(table))
    want_grad, = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_()
    got = hashed_lookup(t, torch.from_numpy(ids), num_hashes)
    got_grad, = torch.autograd.grad(got, t, torch.from_numpy(cot))
    np.testing.assert_array_equal(host(got), np.asarray(want))
    np.testing.assert_allclose(host(got_grad), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)


def test_hashed_lookup_hash_is_uint32_arithmetic():
    """The probes' rows equal Python's exact ``(id mod 2**32) * c mod
    2**32 mod V`` for int32 and int64 ids alike (a table whose row ``r``
    holds ``r``: one probe gives the row, two their mean)."""
    V = 1_000_003
    ids = np.array(EDGE_IDS, np.int64)
    table = torch.arange(V, dtype=torch.float32)[:, None]

    def probe(c):
        return np.array([((int(x) % 2 ** 32) * c % 2 ** 32) % V
                         for x in ids], np.float32)

    one, two = probe(KNUTH + 1), probe(KNUTH + 3)
    for dt in (torch.int32, torch.int64):
        x = torch.tensor(ids, dtype=dt)
        np.testing.assert_array_equal(host(hashed_lookup(table, x, 1))[:, 0],
                                      one)
        np.testing.assert_array_equal(host(hashed_lookup(table, x, 2))[:, 0],
                                      (one + two) / 2)
