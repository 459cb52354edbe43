"""Parity of the port's recsys serving path with the JAX reference, on the
CPU: configs, synthetic batches, init, ``forward`` for all four
architectures, the query tower, retrieval scores, the interactions, and
the two-stage flow (exact ``bta`` retrieval, then the full-model
re-rank).

The reference's parameters (``init_params`` with ``PRNGKey(0)``) cross to
the port through ``convert.recsys_params_from_reference``, so both
packages compute over the identical state. Logits and query embeddings
agree within 1e-5 relative plus 1e-4 absolute: the same fp32 arithmetic
in other summation orders (XLA:CPU against PyTorch's CPU kernels), the
absolute term for logits that cancel to near zero.

Training: ``loss_fn`` and the gradient of every parameter leaf against
``jax.value_and_grad`` of the reference's ``loss_fn``, within 1e-5
relative plus 1e-6 absolute (the same fp32 formulas summed in other
orders; the absolute term for entries of rows that few ids reach); and
the backward passes of kernels B5 and B6 (``torch.autograd.Function``
objects: plain PyTorch behind the kernel's forward, the same code on
every device) against autograd through plain PyTorch indexing and
through the plain versions, and against ``jax.vjp`` of the reference's
``kernels/ref.py`` oracles, within the same tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import from_matrix_factorization as ref_from_mf
from repro.kernels.ref import embedding_bag_ref as ref_bag
from repro.kernels.ref import fm_interaction_ref as ref_fm
from repro.data.synthetic import recsys_batches as ref_recsys_batches
from repro.models import recsys as ref_recsys
from repro.models.common import ACTIVATIONS as REF_ACTIVATIONS
from repro.models.common import MeshRules as RefMeshRules
from repro.models.common import count_params as ref_count_params
from repro.serving.server import TopKServer as RefServer
from repro.serving.server import TwoStageRanker as RefRanker
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.convert import recsys_params_from_reference
from repro_torch.core.seplr import SepLRModel
from repro_torch.data.synthetic import recsys_batches
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain, take_rows)
from repro_torch.kernels.fm_interaction import (fm_interaction,
                                                fm_interaction_plain)
from repro_torch.models import recsys
from repro_torch.models.common import ACTIVATIONS, MeshRules, count_params
from repro_torch.train.tree import tree_flatten_with_path, path_key
from repro_torch.serving.server import TopKServer, TwoStageRanker

from _torch_parity import host

RTOL, ATOL = 1e-5, 1e-4
ARCHS = sorted(a for a, s in REGISTRY.items() if s.family == "recsys")


def _assert_close(got, want):
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _both(arch_id):
    """The smoke config of each package, the reference's params and the
    port's copy of them on the CPU."""
    ref_cfg = ref_get_arch(arch_id).make_smoke_config()
    ref_params = ref_recsys.init_params(ref_cfg, jax.random.PRNGKey(0))
    host_params = jax.tree_util.tree_map(np.asarray, ref_params)
    params = recsys_params_from_reference(host_params, device="cpu")
    return ref_cfg, ref_params, get_arch(arch_id).make_smoke_config(), params


def _batch(cfg, b, seed=0):
    return next(recsys_batches(seed, cfg.n_dense, cfg.n_sparse,
                               cfg.vocab_per_field, b))


def _fields(cfg):
    # the reference's compute_dtype is read by no code; the port has none
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "compute_dtype"}


def test_registry_and_configs_equal_the_reference():
    assert set(ARCHS) == {"fm", "deepfm", "dcn-v2", "dlrm-rm2"}
    for arch_id in ARCHS:
        spec, ref = get_arch(arch_id), ref_get_arch(arch_id)
        assert (spec.family, spec.source) == (ref.family, ref.source)
        assert [dataclasses.asdict(s) for s in spec.shapes] == \
            [dataclasses.asdict(s) for s in ref.shapes]
        assert spec.shape("serve_bulk").dims == {"batch": 262144}
        for make in ("make_config", "make_smoke_config"):
            cfg, ref_cfg = getattr(spec, make)(), getattr(ref, make)()
            assert _fields(cfg) == _fields(ref_cfg)
            assert cfg.param_count() == ref_cfg.param_count()
            assert cfg.interaction_input == ref_cfg.interaction_input
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    with pytest.raises(KeyError, match="no shape"):
        get_arch("deepfm").shape("decode_32k")


def test_synthetic_batches_are_the_reference_batches():
    cfg = get_arch("dlrm-rm2").make_smoke_config()
    args = (3, cfg.n_dense, cfg.n_sparse, cfg.vocab_per_field, 16)
    for got, want, _ in zip(recsys_batches(*args), ref_recsys_batches(*args),
                            range(2)):
        for key in ("dense", "sparse", "label"):
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_and_query_tower_match_reference(arch_id):
    ref_cfg, ref_params, cfg, params = _both(arch_id)
    assert count_params(params) == ref_count_params(ref_params) \
        == cfg.param_count()
    batch = _batch(cfg, 32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    before = (embedding_bag.launches, fm_interaction.launches)
    logits = recsys.forward(params, batch, cfg)
    assert logits.shape == (32,) and bool(torch.isfinite(logits).all())
    _assert_close(logits, ref_recsys.forward(ref_params, jbatch, ref_cfg))
    u = recsys.query_tower(params, batch, cfg)
    _assert_close(u, ref_recsys.query_tower(ref_params, jbatch, ref_cfg))
    cand = np.random.default_rng(1).standard_normal(
        (50, u.shape[1])).astype(np.float32)
    _assert_close(recsys.retrieval_scores(params, batch, cand, cfg),
                  ref_recsys.retrieval_scores(ref_params, jbatch,
                                              jnp.asarray(cand), ref_cfg))
    # CPU tensors take the kernels' plain versions: no launch
    assert (embedding_bag.launches, fm_interaction.launches) == before


def test_init_params_on_a_generator():
    for arch_id in ARCHS:
        cfg = get_arch(arch_id).make_smoke_config()
        params = recsys.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        assert count_params(params) == cfg.param_count()
        again = recsys.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
        torch.testing.assert_close(params["embed"], again["embed"],
                                   rtol=0, atol=0)
    emb = params["embed"]
    assert abs(float(emb.std()) - cfg.embed_dim ** -0.5) < 0.05


def test_dot_interaction_pair_order_and_cross_layer():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((3, 6, 4)).astype(np.float32)
    got = recsys.dot_interaction(torch.from_numpy(v))
    assert got.shape == (3, 15)
    _assert_close(got, ref_recsys.dot_interaction(jnp.asarray(v)))
    iu, ju = torch.triu_indices(6, 6, offset=1)
    riu, rju = jnp.triu_indices(6, k=1)
    np.testing.assert_array_equal(host(iu), np.asarray(riu))
    np.testing.assert_array_equal(host(ju), np.asarray(rju))
    x0, x, b = (rng.standard_normal((5, 4)).astype(np.float32)
                for _ in range(3))
    w = rng.standard_normal((4, 4)).astype(np.float32)
    _assert_close(
        recsys.cross_layer(*map(torch.from_numpy, (x0, x, w, b[0]))),
        ref_recsys.cross_layer(*map(jnp.asarray, (x0, x, w, b[0]))))


def test_activations_match_reference():
    x = np.linspace(-4, 4, 41).astype(np.float32)
    assert set(ACTIVATIONS) == set(REF_ACTIVATIONS)
    for name, fn in ACTIVATIONS.items():
        np.testing.assert_allclose(host(fn(torch.from_numpy(x))),
                                   np.asarray(REF_ACTIVATIONS[name](
                                       jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_two_stage_flow_matches_reference():
    """Exact ``bta`` top-100 of 2,000 items from the query tower, then the
    full DeepFM forward over every (query, candidate) pair with the
    candidate's id in the last sparse field, as
    ``examples/recsys_retrieval.py`` does: the same ids and scores."""
    ref_cfg, ref_params, cfg, params = _both("deepfm")
    rng = np.random.default_rng(1)
    n_items = 2000
    cand = (rng.standard_normal((n_items, cfg.embed_dim)).astype(np.float32)
            * (1.0 / np.sqrt(1.0 + rng.random(n_items)))[:, None]
            ).astype(np.float32)
    queries = _batch(cfg, 4, seed=7)

    def pairs(query_batch, cand_ids):
        B, N = cand_ids.shape
        sp = np.repeat(np.asarray(query_batch["sparse"]), N, axis=0)
        sp[:, -1] = cand_ids.reshape(-1) % cfg.vocab_per_field
        return {"dense": np.zeros((B * N, 0), np.float32), "sparse": sp}

    def rerank(query_batch, cand_ids):
        logits = recsys.forward(params, pairs(query_batch, cand_ids), cfg)
        return host(logits).reshape(cand_ids.shape)

    def ref_rerank(query_batch, cand_ids):
        b = {k: jnp.asarray(v) for k, v in pairs(query_batch,
                                                 cand_ids).items()}
        return np.asarray(ref_recsys.forward(ref_params, b, ref_cfg)
                          ).reshape(cand_ids.shape)

    U = recsys.query_tower(params, queries, cfg)
    assert isinstance(U, torch.Tensor)
    ranker = TwoStageRanker(
        TopKServer(SepLRModel(cand, device="cpu"), max_batch=16,
                   block_size=256, device="cpu"), rerank, retrieve_n=100)
    ids, scores = ranker.rank(queries, U, k=5, method="bta")
    ref_U = ref_recsys.query_tower(
        ref_params, {k: jnp.asarray(v) for k, v in queries.items()}, ref_cfg)
    ref_ranker = RefRanker(RefServer(ref_from_mf(jnp.asarray(cand), "items"),
                                     max_batch=16, block_size=256),
                           ref_rerank, retrieve_n=100)
    ref_ids, ref_scores = ref_ranker.rank(queries, ref_U, k=5, method="bta")
    assert ids.shape == (4, 5)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=RTOL, atol=ATOL)
    st = ranker.retrieval.stats["bta"]
    assert st.n_queries == 4
    assert st.scores_per_query == \
        ref_ranker.retrieval.stats["bta"].scores_per_query


# ---------------------------------------------------------------------------
# Training: the loss and its gradients, B5's and B6's backward passes
# ---------------------------------------------------------------------------

GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_and_every_gradient_match_reference(arch_id):
    """``loss_fn``'s loss, ``bce`` and ``acc``, and the gradient of every
    parameter leaf (a dense table gradient for the embedding and the
    linear weights), against ``jax.value_and_grad``, on the same batch."""
    ref_cfg, ref_params, cfg, params = _both(arch_id)
    batch = _batch(cfg, 64, seed=2)
    (ref_loss, ref_m), ref_grads = jax.value_and_grad(
        ref_recsys.loss_fn, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    flat = tree_flatten_with_path(params)
    leaves = [x.requires_grad_() for _, x in flat]
    loss, m = recsys.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    loss, m = loss.detach(), {k: v.detach() for k, v in m.items()}
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(float(m["bce"]), float(ref_m["bce"]),
                               rtol=1e-6)
    assert float(m["acc"]) == float(ref_m["acc"])
    ref_flat = dict((path_key(tuple(getattr(k, "key", getattr(k, "idx", k))
                                    for k in path)), g) for path, g in
                    jax.tree_util.tree_flatten_with_path(ref_grads)[0])
    assert sorted(ref_flat) == sorted(path_key(path) for path, _ in flat)
    for (path, _), g in zip(flat, grads):
        want = np.asarray(ref_flat[path_key(path)])
        assert tuple(g.shape) == want.shape
        np.testing.assert_allclose(host(g), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path_key(path))
    assert np.abs(np.asarray(ref_flat["embed"])).max() > 0


@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_specs_match_reference(arch_id):
    ref_cfg = ref_get_arch(arch_id).make_smoke_config()
    cfg = get_arch(arch_id).make_smoke_config()
    for rules, ref_rules in ((MeshRules(), RefMeshRules()),
                             (MeshRules(tp=None), RefMeshRules(tp=None))):
        want = jax.tree_util.tree_map(
            tuple, ref_recsys.param_specs(ref_cfg, ref_rules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert recsys.param_specs(cfg, rules) == want


def _bag_case(seed, v, d, b, f):
    """A table and ids with duplicates, ids in ``[-V, 0)`` and a few out of
    range (their bags are NaN; their rows get no gradient)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = (rng.zipf(1.3, (b, f)) % v).astype(np.int32)
    ids[::3, 0] -= v                          # [-V, 0): row V + id
    ids[5, 1], ids[7, 2] = v, -v - 1          # out of range
    grad = rng.standard_normal((b, d)).astype(np.float32)
    return table, ids, grad


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [1, 10])
def test_embedding_bag_backward(mode, d):
    """B5's gradient: the Function's backward against autograd through
    plain PyTorch indexing (PyTorch's own scatter), through the plain
    version, and ``jax.vjp`` of ``embedding_bag_ref`` (``jnp.take``)."""
    table, ids, grad = _bag_case(d, 300, d, 64, 39)
    t = torch.from_numpy(table)
    ti, tg = torch.from_numpy(ids), torch.from_numpy(grad)

    def vjp(fn):
        x = t.clone().requires_grad_()
        return host(torch.autograd.grad(fn(x), x, tg)[0])

    def by_indexing(x):
        row = torch.where(ti < 0, ti + 300, ti).long()
        valid = (row >= 0) & (row < 300)
        rows = x[torch.where(valid, row, 0)] * valid[..., None]
        return rows.sum(1) if mode == "sum" else rows.mean(1)

    got = vjp(lambda x: embedding_bag(x, ti, mode))
    _, ref_vjp = jax.vjp(lambda x: ref_bag(x, jnp.asarray(ids), mode=mode),
                         jnp.asarray(table))
    for want in (vjp(by_indexing),
                 vjp(lambda x: embedding_bag_plain(x, ti, mode)),
                 np.asarray(ref_vjp(jnp.asarray(grad))[0])):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert got[299].any() and not got[~np.isin(np.arange(300), np.where(
        ids < 0, ids + 300, ids))].any()


def test_take_rows_backward_and_float16():
    """The field lookup's gradient (the embedding table's, in every
    model) against ``jax.vjp`` of ``jnp.take``; a float16 table gets a
    float16 gradient of the float32 sums."""
    table, ids, _ = _bag_case(3, 200, 4, 32, 8)
    g = np.random.default_rng(4).standard_normal((32, 8, 4)).astype(
        np.float32)
    x = torch.from_numpy(table).requires_grad_()
    got = torch.autograd.grad(take_rows(x, torch.from_numpy(ids)), x,
                              torch.from_numpy(g))[0]
    _, ref_vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids), axis=0),
                         jnp.asarray(table))
    want = np.asarray(ref_vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(host(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    x16 = torch.from_numpy(table).half().requires_grad_()
    got16 = torch.autograd.grad(
        embedding_bag(x16, torch.from_numpy(ids), "sum"), x16,
        torch.from_numpy(g[:, 0]).half())[0]
    assert got16.dtype == torch.float16
    np.testing.assert_allclose(host(got16).astype(np.float32), np.asarray(
        jax.vjp(lambda t: ref_bag(t, jnp.asarray(ids)),
                jnp.asarray(table))[1](jnp.asarray(g[:, 0]))[0]),
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,f,d", [(64, 39, 10), (7, 2, 3), (5, 1, 4)])
def test_fm_interaction_backward(b, f, d):
    """B6's gradient ``g * (s - emb)`` against autograd through the plain
    version and ``jax.vjp`` of ``fm_interaction_ref``."""
    rng = np.random.default_rng(b + f)
    emb = (rng.standard_normal((b, f, d)) * 0.5).astype(np.float32)
    grad = rng.standard_normal(b).astype(np.float32)
    tg = torch.from_numpy(grad)

    def vjp(fn):
        x = torch.from_numpy(emb).requires_grad_()
        return host(torch.autograd.grad(fn(x), x, tg)[0])

    got = vjp(fm_interaction)
    _, ref_vjp = jax.vjp(ref_fm, jnp.asarray(emb))
    for want in (vjp(fm_interaction_plain),
                 np.asarray(ref_vjp(jnp.asarray(grad))[0])):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
