"""The port's LM training path against the JAX reference, on the CPU:
``index_rows``' gradient, ``chunked_xent``, ``loss_fn`` (loss, metrics and
every leaf's gradient) for the gemma-2b and olmoe-1b-7b smoke configs with
remat on and off, remat on against off bitwise, three ``Trainer`` steps
against the reference's ``Trainer``, a preempted-and-resumed LM run
bitwise, and the launcher's ``lm`` family.

The reference's parameters (``init_params`` with ``PRNGKey(0)``) cross to
the port through ``convert.transformer_params_from_reference``; the
batches are ``lm_batches(0, V, 2, 128)``, which both packages make bit
for bit (2 chunks of the smoke configs' ``logit_chunk`` 64).

Tolerances, normwise (``||got - want|| / ||want||``, per leaf). At fp32
both packages run the same arithmetic in other summation orders: 1e-5
(measured: the loss within 7.0e-8 relative, the gradients within 9.1e-7
for gemma-2b and 7.8e-7 for olmoe-1b-7b). At bf16, 5e-2: gemma-2b's
gradients measured within 1.38% of the reference's (the packages round at
other points; the port also sums the ``embed`` gradient in fp32 where the
reference scatter-adds it in bf16, ``embed`` 1.08%). olmoe-1b-7b at bf16:
the reference routes 2 tokens a layer to another expert pair than at
fp32, each a near-tie (the 2nd and 3rd router probabilities within
7.4e-5 to 2.3e-4 of each other, against a median gap of 0.04), and the
port routes those tokens as the fp32 runs do; a flip moves the whole
gradient (the reference's own bf16 gradient is 8.7% from its fp32 one at
the router, 6.4% at ``moe_down``), so the port's bf16 gradient cannot be
held to the reference's bf16 gradient leaf by leaf. The test holds the
port's routing to the reference's bf16 routing up to each row's first
flip, which must be a near-tie (its k-th and (k+1)-th router logits within
``NEAR_TIE`` of the largest, as ``tests/test_torch_transformer.py``
holds them), the loss, xent and aux loss to the reference's bf16 values within 5e-2
relative (measured: 6.8e-5, 6.9e-5, 3.7e-4), and every leaf of the
gradient to the reference's fp32 gradient within 5e-2 (measured: 1.24%
at most). Three AdamW steps at fp32: the losses within 1e-5 relative,
every parameter within 1e-4 of the largest (Adam's first steps move an
entry by about ``lr`` whatever its gradient's size, as
``tests/test_torch_train.py`` says).
"""

import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data.loader import PrefetchLoader as RefLoader
from repro.data.synthetic import lm_batches as ref_lm_batches
from repro.models import transformer as ref_tf
from repro.models.common import rms_norm as ref_rms_norm
from repro.train import optimizer as ref_opt
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_arch
from repro_torch.convert import transformer_params_from_reference
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.models.embedding import index_rows
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import (SimulatedPreemption, Trainer,
                                       TrainerConfig)
from repro_torch.train.tree import tree_leaves, tree_unflatten

from _torch_parity import host

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ARCHS = ("gemma-2b", "olmoe-1b-7b")
B, S = 2, 128
NEAR_TIE = 3e-2


def _normwise(got, want) -> float:
    got = np.asarray(host(got), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _configs(arch, dtype, remat=True):
    tdt, jdt = DTYPES[dtype]
    ref_cfg = dataclasses.replace(ref_get_arch(arch).make_smoke_config(),
                                  compute_dtype=jdt, remat=remat)
    cfg = dataclasses.replace(get_arch(arch).make_smoke_config(),
                              compute_dtype=tdt, remat=remat)
    return ref_cfg, cfg


def _batch(vocab):
    return next(ref_lm_batches(0, vocab, B, S))


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's ``(params, loss, metrics, gradient leaves)`` on the
    first batch, through ``jax.value_and_grad(loss_fn)``."""
    ref_cfg, _ = _configs(arch, dtype)
    params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(ref_cfg.vocab_size).items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.loss_fn(p, b, ref_cfg), has_aux=True))
    (loss, metrics), grads = fn(params, batch)
    return (params, float(loss), {k: float(v) for k, v in metrics.items()},
            [np.asarray(g, np.float32)
             for g in jax.tree_util.tree_leaves(grads)])


def _port(cfg, params, batch, moe_aux=None):
    """The port's ``(loss, metrics, gradient leaves)``."""
    leaves = [x.detach().clone().requires_grad_()
              for x in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = tf.loss_fn(tree, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    if moe_aux is not None:
        with torch.no_grad():
            tf.forward(tree, batch["tokens"], cfg, moe_aux=moe_aux)
    return loss, metrics, grads


def _flips_are_near_ties(stats, ref_params, ref_cfg, tokens):
    """The reference's routing recomputed layer by layer over its own
    residual stream (its ``_attention_block``, ``rms_norm`` and fp32
    router top-k) against the port's ``expert_ids`` in ``stats``: each
    row's first token routed to another expert set must be a near-tie.
    Returns each row's first flip (``S`` where none)."""
    k, dt = ref_cfg.moe_top_k, ref_cfg.compute_dtype
    rules = ref_tf.MeshRules()
    positions = jnp.arange(tokens.shape[1])

    @jax.jit
    def layer(lp, x):
        x = x + ref_tf._attention_block(lp, x, ref_cfg, rules, positions)[0]
        h = ref_rms_norm(x, lp["ln2"], ref_cfg.norm_eps)
        logits = h.reshape(-1, h.shape[-1]).astype(jnp.float32) @ lp["router"]
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
        return x + ref_tf._ffn_block(lp, x, ref_cfg, rules)[0], logits, ids

    x = ref_params["embed"].astype(dt)[jnp.asarray(tokens)]
    first = np.full(tokens.shape[0], tokens.shape[1])
    for i, aux in enumerate(stats):
        x, logits, ids = layer(
            jax.tree_util.tree_map(lambda a: a[i], ref_params["layers"]), x)
        flip = (np.sort(host(aux["expert_ids"]), -1)
                != np.sort(np.asarray(ids), -1)).any(-1)
        top = -np.sort(-np.asarray(logits), axis=-1)[:, :k + 1]
        near = (-np.diff(top, axis=-1)).min(-1) \
            <= NEAR_TIE * np.abs(top).max(-1)
        for b, row in enumerate(flip.reshape(tokens.shape)):
            hit = np.flatnonzero(row)
            if hit.size and hit[0] < first[b]:
                assert near.reshape(tokens.shape)[b, hit[0]], (i, b, hit[0])
                first[b] = hit[0]
    return first


def _port_params(ref_params):
    return transformer_params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")


# ---------------------------------------------------------------------------
# the token lookup's gradient and the chunked head
# ---------------------------------------------------------------------------


def test_index_rows_gradient_matches_reference():
    """``table[ids]``'s gradient, repeated, negative and out-of-range ids
    included (clamped as jnp clamps them), against ``jax.vjp``."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(-60, 60, (4, 33)).astype(np.int32)
    ids[0, :10] = 7                                         # a long run
    cot = rng.standard_normal((4, 33, 6)).astype(np.float32)
    want_rows, vjp = jax.vjp(lambda t: t[jnp.asarray(ids)],
                             jnp.asarray(table))
    want, = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_()
    rows = index_rows(t, torch.from_numpy(ids))
    got, = torch.autograd.grad(rows, t, torch.from_numpy(cot))
    np.testing.assert_array_equal(host(rows), np.asarray(want_rows))
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("chunk,dtype", [
    (16, "float32"), (64, "float32"), (128, "float32"),
    (48, "float32"),            # 128 % 48 != 0: one chunk of S
    (500, "float32"),           # longer than S: one chunk
    (32, "bfloat16"),
])
def test_chunked_xent_matches_reference(chunk, dtype):
    """The value and its gradients in ``hidden`` and ``unembed``, a few
    labels outside ``[0, V)`` included (their gold logit is 0 in both)."""
    ref_cfg, cfg = _configs("gemma-2b", dtype)
    ref_cfg = dataclasses.replace(ref_cfg, logit_chunk=chunk)
    cfg = dataclasses.replace(cfg, logit_chunk=chunk)
    rng = np.random.default_rng(chunk)
    V, D = cfg.vocab_size, cfg.d_model
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    unembed = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    labels = _batch(V)["labels"].copy()
    labels[0, :3] = (-1, V, V + 5)
    tdt, jdt = DTYPES[dtype]

    def ref(h, w):
        return ref_tf.chunked_xent({"unembed": w}, h.astype(jdt),
                                   jnp.asarray(labels), ref_cfg,
                                   ref_tf.MeshRules())

    want, (want_h, want_w) = jax.jit(jax.value_and_grad(ref, (0, 1)))(
        jnp.asarray(hidden), jnp.asarray(unembed))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(unembed).requires_grad_()
    got = tf.chunked_xent({"unembed": w}, h.to(tdt),
                          torch.from_numpy(labels), cfg)
    got_h, got_w = torch.autograd.grad(got, (h, w))
    assert got.dtype == torch.float32
    tol = TOL[dtype]
    assert abs(float(got.detach()) - float(want)) <= tol * abs(float(want))
    assert _normwise(got_h, want_h) <= tol
    assert _normwise(got_w, want_w) <= tol


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradient_match_reference(arch, dtype, remat):
    ref_params, want_loss, want_m, want_g = _reference(arch, dtype)
    ref_cfg, cfg = _configs(arch, dtype, remat)
    batch = _batch(cfg.vocab_size)
    params = _port_params(ref_params)
    aux = [] if cfg.moe else None
    loss, metrics, grads = _port(cfg, params, batch, aux)
    assert set(metrics) == {"xent", "aux_loss"}
    tol = TOL[dtype]
    for key, got, want in (("loss", loss, want_loss),
                           ("xent", metrics["xent"], want_m["xent"]),
                           ("aux_loss", metrics["aux_loss"],
                            want_m["aux_loss"])):
        assert got.dtype == torch.float32
        assert abs(float(got.detach()) - want) <= tol * max(abs(want), 1e-30), key
    if not cfg.moe:
        assert float(metrics["aux_loss"]) == 0.0
    if cfg.moe and dtype == "bfloat16":
        # the routing alike up to each row's first flip, a near-tie; the
        # gradient against the reference's fp32 one (module docstring)
        _flips_are_near_ties(aux, ref_params, ref_cfg, batch["tokens"])
        want_g = _reference(arch, "float32")[3]
    assert len(grads) == len(want_g)
    errs = [_normwise(g, w) for g, w in zip(grads, want_g)]
    assert max(errs) <= tol, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_bitwise_the_same_loss_and_gradient(arch):
    cfg = get_arch(arch).make_smoke_config()
    params = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _batch(cfg.vocab_size)
    on = _port(cfg, params, batch)
    off = _port(dataclasses.replace(cfg, remat=False), params, batch)
    assert torch.equal(on[0], off[0])
    for key in on[1]:
        assert torch.equal(on[1][key], off[1][key])
    for a, b in zip(on[2], off[2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trainer, resume and the launcher
# ---------------------------------------------------------------------------


def test_three_trainer_steps_track_the_reference():
    """gemma-2b's smoke config at fp32 from the reference's parameters, on
    the same three batches through both packages' ``Trainer``."""
    ref_cfg, cfg = _configs("gemma-2b", "float32")
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = _port_params(ref_params)
    kw = dict(kind="adamw", lr=3e-3, warmup_steps=1, total_steps=3)
    V = cfg.vocab_size
    ref_tr = RefTrainer(lambda p, b: ref_tf.loss_fn(p, b, ref_cfg),
                        ref_params, ref_opt.OptimizerConfig(**kw),
                        RefLoader(lambda: ref_lm_batches(0, V, B, S)),
                        RefTrainerConfig(total_steps=3, log_every=1))
    ref_tr.run()
    tr = Trainer(lambda p, b: tf.loss_fn(p, b, cfg), params,
                 OptimizerConfig(**kw),
                 PrefetchLoader(lambda: lm_batches(0, V, B, S)),
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
    assert int(tr.opt_state.step) == 3


def test_preempted_lm_run_resumes_bitwise():
    """gemma-2b's smoke config (bf16 compute, remat): checkpoints every 2
    steps, preempted at step 3, resumed from step 2 to step 6: parameters,
    both moments and the losses of steps 3-6 bitwise those of an
    uninterrupted run."""
    cfg = get_arch("gemma-2b").make_smoke_config()
    opt = OptimizerConfig(kind="adamw", lr=3e-3, warmup_steps=2,
                          total_steps=6)

    def trainer(**kw):
        params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        return Trainer(lambda p, b: tf.loss_fn(p, b, cfg), params, opt,
                       PrefetchLoader(lambda: lm_batches(0, cfg.vocab_size,
                                                         2, 64)),
                       TrainerConfig(total_steps=6, log_every=1, **kw))

    with tempfile.TemporaryDirectory() as d:
        cut = trainer(ckpt_every=2, ckpt_dir=d, fail_at_step=3)
        with pytest.raises(SimulatedPreemption):
            cut.run()
        cut.manager.wait()
        resumed = trainer(ckpt_every=2, ckpt_dir=d)
        resumed.run()
    full = trainer(ckpt_every=100)
    full.run()
    assert resumed.history[0]["step"] == 3 and resumed.step == 6
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history][2:]
    for a, b in zip(tree_leaves({"p": resumed.params,
                                 "o": resumed.opt_state}),
                    tree_leaves({"p": full.params, "o": full.opt_state})):
        assert torch.equal(a, b)


def test_launcher_trains_gemma_on_the_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        tr = launch_train.main(["--arch", "gemma-2b", "--device", "cpu",
                                "--steps", "3", "--ckpt-dir", d])
        assert tr.step == 3 and os.listdir(d) == ["step_0000000003"]
    assert np.isfinite([h["loss"] for h in tr.history]).all()
    assert "arch=gemma-2b config=gemma-2b-smoke steps=3 loss" in \
        capsys.readouterr().out
