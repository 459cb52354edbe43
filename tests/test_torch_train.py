"""The port's training substrate against the reference's, on the CPU:
``train/optimizer.py``, ``train/checkpoint.py``, ``train/trainer.py``,
``train/compression.py``, ``data/loader.py`` and ``launch/train.py``,
with inputs made from a numpy seed and handed to both packages (the
reference's parameters and optimizer state cross through
``repro_torch.convert``).

Tolerances. One ``apply_updates`` call on identical inputs: 1e-6
relative (plus 1e-9 absolute for entries that cancel to near zero): the
same float32 formulas, where PyTorch may fuse ``a * b + c`` into one
rounding that XLA takes in two. The learning rate within 1e-6 relative
(``cos`` of XLA against PyTorch's). Twenty AdamW steps of ``fm-t``: the
losses within 1e-4 relative of the reference's, and the parameters within
1e-4 of the largest parameter (Adam's first steps move an entry by about
``lr`` whatever its gradient's size, so a gradient that is rounding noise
in one package and other noise in the other moves that entry by up to
2 ``lr``; measured here: losses within 1.1e-7 relative, parameters within
1.8e-7 of a largest 1.85). Compression: the int8
payloads equal (``round`` is half to even in both), the rest within 1e-6
of the largest value."""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.loader import PrefetchLoader as RefLoader
from repro.data.synthetic import recsys_batches as ref_recsys_batches
from repro.models import recsys as ref_recsys
from repro.train import optimizer as ref_opt
from repro.train.checkpoint import CheckpointManager as RefManager
from repro.train.compression import ef_compress as ref_ef_compress
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.convert import (opt_state_from_reference,
                                 recsys_params_from_reference)
from repro_torch.core.mesh import make_mesh
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import recsys_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import recsys
from repro_torch.models.common import MeshRules
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import (compressed_psum, dequantize_int8,
                                           ef_compress,
                                           make_compressed_allreduce,
                                           quantize_int8)
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         apply_updates, global_norm,
                                         init_state, lr_schedule)
from repro_torch.train.trainer import (SimulatedPreemption, Trainer,
                                       TrainerConfig, make_train_step)
from repro_torch.train.tree import tree_leaves, tree_map

from _torch_parity import host

RCFG = recsys.RecsysConfig("fm-t", "fm", 0, 8, 4, 200)
REF_RCFG = ref_recsys.RecsysConfig("fm-t", "fm", 0, 8, 4, 200)
KINDS = ["adamw", "adam", "adagrad", "sgd"]


def _loss(p, b):
    return recsys.loss_fn(p, b, RCFG)


def _loader(batch=32):
    return PrefetchLoader(lambda: recsys_batches(0, 0, 8, 200, batch))


def _params(seed=0):
    return recsys.init_params(RCFG, torch.Generator().manual_seed(seed),
                              "cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(got, want, rtol, atol=0.0):
    got_l = [host(x) for x in tree_leaves(got)]
    want_l = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The optimizer against the reference's
# ---------------------------------------------------------------------------


def _opt_case(kind, rng):
    """A tree with a 0-d, a 1-d and 2-d leaves (weight decay reads the
    rank), gradients with a global norm of ~30 (clipped to 1), and a
    state five steps in (moments nonzero)."""
    shapes = {"bias": (), "linear": (50,), "embed": (50, 4),
              "deep": [{"w": (16, 8), "b": (8,)}]}

    def draw(scale, positive=False):
        def leaf(shape):
            x = rng.standard_normal(shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return jax.tree_util.tree_map(leaf, shapes,
                                      is_leaf=lambda s: isinstance(s, tuple))

    params, grads = draw(1.0), draw(2.0)
    mu = draw(0.1)
    if kind in ("adam", "adamw"):
        nu = draw(0.01, positive=True)
    elif kind == "adagrad":
        mu, nu = draw(0.5, positive=True), jax.tree_util.tree_map(
            lambda x: np.zeros((), np.float32), params)
    else:
        nu = jax.tree_util.tree_map(lambda x: np.zeros((), np.float32),
                                    params)
    return params, grads, (np.int32(5), mu, nu)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_updates_matches_reference(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    params, grads, state = _opt_case(kind, rng)
    cfg = OptimizerConfig(kind=kind, lr=1e-2, warmup_steps=3,
                          total_steps=20)
    ref_cfg = ref_opt.OptimizerConfig(kind=kind, lr=1e-2, warmup_steps=3,
                                      total_steps=20)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    want_p, want_s, want_m = ref_opt.apply_updates(
        ref_cfg, to_j(params), to_j(grads),
        ref_opt.OptState(*to_j(state)))
    got_p, got_s, got_m = apply_updates(
        cfg, recsys_params_from_reference(params, "cpu"),
        recsys_params_from_reference(grads, "cpu"),
        opt_state_from_reference(state, "cpu"))
    assert isinstance(got_s, OptState) and int(got_s.step) == 6
    _assert_trees(got_p, want_p, 1e-6, 1e-9)
    _assert_trees(got_s.mu, want_s.mu, 1e-6, 1e-9)
    _assert_trees(got_s.nu, want_s.nu, 1e-6, 1e-9)
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=1e-6)
    assert float(got_m["grad_norm"]) > 1.0          # the clip was active


def test_init_state_matches_reference():
    """Adam keeps two moments of the parameters' shapes; Adagrad and SGD a
    0-d ``nu`` a leaf; the step starts at 0 (int32)."""
    ref_params = ref_recsys.init_params(REF_RCFG, jax.random.PRNGKey(0))
    params = recsys_params_from_reference(_np_tree(ref_params), "cpu")
    for kind in KINDS:
        st = init_state(OptimizerConfig(kind=kind), params)
        want = ref_opt.init_state(ref_opt.OptimizerConfig(kind=kind),
                                  ref_params)
        assert st.step.dtype == torch.int32 and int(st.step) == 0
        _assert_trees(st.mu, want.mu, 0)
        _assert_trees(st.nu, want.nu, 0)


def test_lr_schedule_matches_reference_at_every_step():
    cfg = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    ref_cfg = ref_opt.OptimizerConfig(lr=3e-3, warmup_steps=10,
                                      total_steps=100, min_lr_ratio=0.1)
    got = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(101)]
    want = [float(ref_opt.lr_schedule(ref_cfg, jnp.int32(s)))
            for s in range(101)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    params, grads, _ = _opt_case("adamw", rng)
    np.testing.assert_allclose(
        float(global_norm(recsys_params_from_reference(grads, "cpu"))),
        float(ref_opt.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                         grads))),
        rtol=1e-6)


class TestOptimizer:
    """``tests/test_train.py``'s optimizer cases, on the port."""

    @pytest.mark.parametrize("kind", KINDS)
    def test_converges_on_quadratic(self, kind):
        lr = 0.5 if kind == "adagrad" else 0.05   # adagrad's steps shrink
        cfg = OptimizerConfig(kind=kind, lr=lr, warmup_steps=0,
                              total_steps=400, weight_decay=0.0,
                              momentum=0.5)
        p = {"w": torch.tensor([3.0, -2.0, 1.0])}
        st = init_state(cfg, p)
        for _ in range(300):
            g = {"w": 2 * p["w"]}                  # grad of sum(w ** 2)
            p, st, _ = apply_updates(cfg, p, g, st)
        assert float(torch.sum(p["w"] ** 2)) < 1e-2

    def test_lr_schedule_shape(self):
        cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
        lrs = [float(lr_schedule(cfg, s)) for s in range(101)]
        assert lrs[0] < lrs[10]                 # warmup
        assert abs(lrs[10] - 1.0) < 0.02        # peak
        assert lrs[100] == pytest.approx(0.1, rel=0.05)   # floor

    def test_grad_clipping(self):
        cfg = OptimizerConfig(grad_clip=1.0, lr=1.0, warmup_steps=0)
        p = {"w": torch.zeros(3)}
        g = {"w": torch.tensor([100.0, 0.0, 0.0])}
        _, _, m = apply_updates(cfg, p, g, init_state(cfg, p))
        assert float(m["grad_norm"]) == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


class TestCheckpoint:
    """``tests/test_train.py``'s checkpoint cases, on the port."""

    def test_roundtrip_and_gc(self):
        tree = {"a": torch.arange(10.0), "b": [{"w": torch.ones((3, 4))}],
                "opt": (torch.tensor(7, dtype=torch.int32), torch.zeros(2))}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=2, async_save=False)
            for step in (10, 20, 30):
                mgr.save(step, tree, block=True)
            assert mgr.list_steps() == [20, 30]   # keep-last-2 GC
            restored, step = mgr.restore(tree)
            assert step == 30
            np.testing.assert_array_equal(host(restored["a"]),
                                          np.arange(10.0))
            assert int(restored["opt"][0]) == 7
            with open(os.path.join(d, "step_0000000030",
                                   "manifest.json")) as f:
                manifest = json.load(f)
            assert manifest["leaves"] == ["a", "b|0|w", "opt|0", "opt|1"]
            assert manifest["nbytes"] == 4 * (10 + 12 + 1 + 2)

    def test_atomicity_tmp_never_visible(self):
        tree = {"a": torch.ones(4)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=3, async_save=False)
            mgr.save(1, tree, block=True)
            assert not any(f.endswith(".tmp") for f in os.listdir(d))

    def test_restore_rejects_shape_mismatch(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_save=False)
            mgr.save(1, {"a": torch.ones(4)}, block=True)
            with pytest.raises(ValueError):
                mgr.restore({"a": torch.ones(5)})

    def test_async_save_snapshots_before_in_place_updates(self):
        """The host copy is taken before ``save`` returns: an in-place
        update right after it does not reach the file."""
        p = torch.zeros(1000)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=1)
            mgr.save(1, {"p": p})
            p.add_(1.0)
            restored, _ = mgr.restore({"p": p})
            assert float(restored["p"].abs().max()) == 0.0


def _trainer_tree(params, state):
    return {"params": params, "opt": state}


def test_checkpoints_cross_between_the_packages():
    """A reference checkpoint of ``{"params", "opt"}`` restores into the
    port's tree with equal leaves and step, and a port checkpoint into
    the reference's; both name the leaves alike."""
    ref_params = ref_recsys.init_params(REF_RCFG, jax.random.PRNGKey(1))
    ref_cfg = ref_opt.OptimizerConfig()
    ref_state = ref_opt.init_state(ref_cfg, ref_params)
    rng = np.random.default_rng(4)
    ref_state = ref_opt.OptState(
        jnp.int32(12),
        jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), ref_state.mu),
        jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.random(x.shape).astype(np.float32)), ref_state.nu))
    ref_tree = _trainer_tree(ref_params, ref_state)
    params = _params(5)
    template = _trainer_tree(params, init_state(OptimizerConfig(), params))
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        RefManager(d1, async_save=False).save(12, ref_tree, block=True)
        got, step = CheckpointManager(d1).restore(template)
        assert step == 12 and int(got["opt"].step) == 12
        assert isinstance(got["opt"], OptState)
        _assert_trees(got, ref_tree, 0)

        port_state = opt_state_from_reference(_np_tree(ref_state), "cpu")
        port_tree = _trainer_tree(params, port_state)
        CheckpointManager(d2, async_save=False).save(7, port_tree,
                                                     block=True)
        back, step = RefManager(d2).restore(ref_tree)
        assert step == 7
        _assert_trees(port_tree, back, 0)
        for d in (d1, d2):
            name = sorted(os.listdir(d))[0]
            with open(os.path.join(d, name, "manifest.json")) as f:
                leaves = json.load(f)["leaves"]
            assert leaves == sorted(
                ["params|bias", "params|embed", "params|linear",
                 "opt|.step", *(f"opt|.{m}|{k}" for m in ("mu", "nu")
                                for k in ("bias", "embed", "linear"))])


def test_restore_deals_split_leaves_over_a_mesh():
    """``shardings`` as a ``core/mesh.py`` layout: the specs of
    ``param_specs`` resolved on a 4-shard CPU mesh whose axis is the tp
    axis; split leaves come back dealt, the rest whole."""
    params = _params(2)
    mesh = make_mesh((4,), ("model",), ["cpu"] * 4)
    specs = recsys.param_specs(RCFG, MeshRules())
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        mgr.save(3, params, block=True)
        got, step = mgr.restore(params, shardings=(mesh, specs))
    assert step == 3 and got["embed"].n_shards == 4
    np.testing.assert_array_equal(np.asarray(got["embed"]),
                                  host(params["embed"]))
    np.testing.assert_array_equal(np.asarray(got["linear"]),
                                  host(params["linear"]))
    assert isinstance(got["bias"], torch.Tensor)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


class TestFaultTolerance:
    """``tests/test_train.py``'s fault-tolerance cases, on the port."""

    def test_crash_resume_bitwise_deterministic(self):
        opt = OptimizerConfig(kind="adamw", lr=1e-2, warmup_steps=2,
                              total_steps=30)
        with tempfile.TemporaryDirectory() as d:
            t1 = Trainer(_loss, _params(), opt, _loader(), TrainerConfig(
                total_steps=30, ckpt_every=10, ckpt_dir=d, fail_at_step=17))
            with pytest.raises(SimulatedPreemption):
                t1.run()
            t2 = Trainer(_loss, _params(), opt, _loader(), TrainerConfig(
                total_steps=30, ckpt_every=10, ckpt_dir=d))
            t2.run()
            assert t2.step == 30
            t3 = Trainer(_loss, _params(), opt, _loader(), TrainerConfig(
                total_steps=30, ckpt_every=1000))
            t3.run()
            for a, b in zip(tree_leaves(_trainer_tree(t2.params,
                                                      t2.opt_state)),
                            tree_leaves(_trainer_tree(t3.params,
                                                      t3.opt_state))):
                assert torch.equal(a, b)          # bitwise

    def test_training_reduces_loss(self):
        opt = OptimizerConfig(kind="adamw", lr=5e-3, warmup_steps=5,
                              total_steps=60)
        tr = Trainer(_loss, _params(), opt, _loader(64),
                     TrainerConfig(total_steps=60, log_every=5))
        tr.run()
        # per-step losses are single-batch samples; compare early/late
        # windows so one noisy batch can't flip the verdict
        losses = [h["loss"] for h in tr.history]
        assert np.mean(losses[:3]) > np.mean(losses[-3:])
        assert set(tr.history[-1]) >= {"loss", "bce", "acc", "lr",
                                       "grad_norm", "step", "step_time",
                                       "stragglers"}


def test_twenty_adamw_steps_track_the_reference():
    """``fm-t`` from the reference's parameters and optimizer state,
    carried across, on the same 20 batches: the losses within 1e-4
    relative, every parameter within 1e-4 of the largest."""
    ref_params = ref_recsys.init_params(REF_RCFG, jax.random.PRNGKey(0))
    ref_cfg = ref_opt.OptimizerConfig(kind="adamw", lr=1e-2,
                                      warmup_steps=2, total_steps=20)
    cfg = OptimizerConfig(kind="adamw", lr=1e-2, warmup_steps=2,
                          total_steps=20)
    ref_state = ref_opt.init_state(ref_cfg, ref_params)
    params = recsys_params_from_reference(_np_tree(ref_params), "cpu")
    state = opt_state_from_reference(_np_tree(ref_state), "cpu")
    ref_step = ref_make_train_step(
        lambda p, b: ref_recsys.loss_fn(p, b, REF_RCFG), ref_cfg,
        donate=False)
    step = make_train_step(_loss, cfg)
    got, want = [], []
    for batch in zip(range(20), ref_recsys_batches(0, 0, 8, 200, 32)):
        b = batch[1]
        ref_params, ref_state, m = ref_step(
            ref_params, ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in
                                 b.items()})
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    scale = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree_util.tree_leaves(ref_params))
    _assert_trees(params, ref_params, 0, 1e-4 * scale)
    assert int(state.step) == int(ref_state.step) == 20


def test_loader_skip_gives_the_reference_batches():
    mk = lambda: recsys_batches(0, 0, 8, 200, 16)  # noqa: E731
    ref_mk = lambda: ref_recsys_batches(0, 0, 8, 200, 16)  # noqa: E731
    for n in (0, 3):
        loader, ref_loader = PrefetchLoader(mk), RefLoader(ref_mk)
        if n:
            loader.skip(n)
            ref_loader.skip(n)
        for _, got, want in zip(range(3), loader, ref_loader):
            for key in ("dense", "sparse", "label"):
                np.testing.assert_array_equal(got[key], want[key])
        loader.close()
        ref_loader.close()


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


class TestCompression:
    """``tests/test_train.py``'s compression cases, on the port, and the
    payloads against the reference's and numpy's."""

    def test_error_feedback_unbiased_over_time(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
        err = torch.zeros_like(x)
        acc = torch.zeros_like(x)
        for _ in range(50):
            q, s, err = ef_compress(x, err)
            acc = acc + dequantize_int8(q, s)
        assert float(torch.max(torch.abs(acc / 50 - x))) < 0.01

    def test_quantize_wire_width(self):
        q, s = quantize_int8(torch.tensor([1.0, -3.0, 2.0]))
        assert q.dtype == torch.int8          # 4x fewer bytes than f32

    def test_ef_compress_matches_reference(self):
        rng = np.random.default_rng(1)
        g = rng.standard_normal(1000).astype(np.float32)
        e = (rng.standard_normal(1000) * 0.01).astype(np.float32)
        # exact halves after scaling: both round half to even
        g[:4] = np.array([0.5, 1.5, -2.5, 127.0], np.float32) \
            * (np.abs(g + e).max() / 127.0)
        q, s, ne = ef_compress(torch.from_numpy(g), torch.from_numpy(e))
        rq, rs, rne = ref_ef_compress(jnp.asarray(g), jnp.asarray(e))
        np.testing.assert_array_equal(host(q), np.asarray(rq))
        np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
        np.testing.assert_allclose(host(ne), np.asarray(rne), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(rne).max()))


def _np_ef(g, e):
    """numpy's error-feedback int8 of one shard."""
    t = (g + e).astype(np.float32)
    scale = np.float32(np.abs(t).max() / np.float32(127.0) + 1e-12)
    q = np.clip(np.round(t / scale), -127, 127).astype(np.int8)
    return q, scale, t - q.astype(np.float32) * scale


@pytest.mark.parametrize("shape,names", [((4,), ("pod",)),
                                         ((2, 2), ("pod", "data"))])
def test_compressed_allreduce_over_a_cpu_mesh_matches_numpy(shape, names):
    """Per-shard gradients and errors ``[n, ...]`` dealt over the ``pod``
    axis of a CPU mesh (4 logical shards, or 2 pods x 2 data replicas):
    the mean of the shards' dequantised payloads and each shard's new
    error, against numpy; ``compressed_psum`` on the stacks alike; the
    errors fed back for a second round."""
    rng = np.random.default_rng(7)
    mesh = make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))
    n = shape[0]
    grads = {"w": rng.standard_normal((n, 6, 5)).astype(np.float32),
             "b": [rng.standard_normal((n, 5)).astype(np.float32)]}
    errs = tree_map(np.zeros_like, grads)
    fn = make_compressed_allreduce(mesh, "pod")
    t_grads = tree_map(torch.from_numpy, grads)
    t_errs = tree_map(torch.from_numpy, errs)
    for _ in range(2):
        mean, t_errs = fn(t_grads, t_errs)
        for g, e, m, ne in zip(tree_leaves(grads), tree_leaves(errs),
                               tree_leaves(mean), tree_leaves(t_errs)):
            parts = [_np_ef(g[i], e[i]) for i in range(n)]
            want = sum(q.astype(np.float32) * s for q, s, _ in parts) / n
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(host(m), want, rtol=1e-6,
                                       atol=1e-6 * scale)
            new = np.stack([r for _, _, r in parts])
            np.testing.assert_allclose(np.asarray(ne), new, rtol=1e-6,
                                       atol=1e-6 * scale)
            pm, pe = compressed_psum(torch.from_numpy(g),
                                     torch.from_numpy(e))
            np.testing.assert_allclose(host(pm), want, rtol=1e-6,
                                       atol=1e-6 * scale)
            np.testing.assert_allclose(host(pe), new, rtol=1e-6,
                                       atol=1e-6 * scale)
        errs = tree_map(np.asarray, t_errs)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_deepfm_on_the_cpu_and_resumes(capsys):
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", "deepfm", "--steps", "12", "--batch", "64",
                "--ckpt-dir", d, "--ckpt-every", "6", "--device", "cpu"]
        tr = launch_train.main(args)
        assert tr.step == 12 and sorted(os.listdir(d)) == [
            "step_0000000006", "step_0000000012"]
        out = capsys.readouterr().out
        assert "arch=deepfm config=deepfm-smoke steps=12 loss" in out
        again = launch_train.main(args[:3] + ["24"] + args[4:])
        assert again.step == 24 and again.history[0]["step"] == 20


@pytest.mark.parametrize("arch,item", [("pna", "ROADMAP A7.6")])
def test_launcher_refuses_the_families_not_ported_yet(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        launch_train.main(["--arch", arch, "--device", "cpu"])
