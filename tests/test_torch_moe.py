"""The port's MoE feed-forward and the LM's sharding against the JAX
reference, on the CPU: ``moe_ffn`` (top-1, top-2, top-8 of 64, a capacity
that drops tokens, an all-zero router), ``moe_ffn_ep`` over meshes of
logical CPU shards, the vocab-sharded ``topk_logits``, ``MeshRules``,
``param_specs`` and ``kv_cache_specs``, and the MoE smoke configs'
``forward``, ``prefill`` and ``serve_step`` under a mesh.

The mesh cases of the reference run as ``tests/test_perf_paths.py`` runs
them: one subprocess with 8 forced host devices
(``--xla_force_host_platform_device_count``) under ``jax.set_mesh``,
launched once for the module, writes inputs and results to an ``.npz``.
The port runs the same cases on ``core/mesh.py`` meshes whose devices
repeat the CPU.

Tolerances. fp32: both packages run the same arithmetic in other orders
(the combine sums a token's ``top_k`` outputs where the reference
scatter-adds them): 1e-5 relative plus 1e-4 absolute, expert ids equal
wherever the router's probabilities are distinct, ``aux_loss`` and
``drop_rate`` within fp32 rounding (1e-6 relative; the drop rate is a
count's share, so equal). bf16: values within ``BF16_TOL``, 3% of the
largest magnitude (as ``tests/test_torch_transformer.py``: the packages
round at other points), and ``drop_rate`` equal, wherever both packages
pick the same experts; the bf16 cases check that they do (the EP path
routes on bf16 logits, so a near-tie could flip; none does here). The
subprocess runs the reference under ``jax.jit`` with
``--xla_allow_excess_precision=false``: otherwise jit fuses the rounding
of the EP router's bf16 logits away (its jitted ``aux_loss`` then differs
from its op-by-op one by 1.4e-4 relative), where the reference's code,
and the port, round them.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as ref_get_arch
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.models.common import MeshRules as RefRules
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels.topk_mips import topk_mips
from repro_torch.models import moe, transformer
from repro_torch.models.common import DEFAULT_RULES, MeshRules

from _torch_parity import host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-4
BF16_TOL = 3e-2
SCALAR_RTOL = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, dtype="float32"):
    got = host(got.float() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_TOL * np.abs(want).max())


def _scalar(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=SCALAR_RTOL,
                               atol=1e-7)


def _ref_params(d, f, e, seed):
    return ref_moe.init_moe(jax.random.PRNGKey(seed), d, f, e)


_ref_moe_ffn = jax.jit(ref_moe.moe_ffn, static_argnums=(2, 3))


def _port(ref_params):
    host_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return params_from_reference(host_params, device="cpu")


def _ref_expert_ids(x, router, top_k, f32_input):
    """The reference's routing, outside the function: ``(probs, ids)``."""
    xr = x.astype(jnp.float32) @ router if f32_input else \
        (x @ router.astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(xr, axis=-1)
    _, ids = jax.lax.top_k(probs, top_k)
    return np.asarray(probs), np.asarray(ids)


def _assert_ids_where_distinct(got_ids, probs, want_ids):
    """Expert ids equal at the tokens whose top-(k+1) probabilities are
    distinct (no tie can reorder them)."""
    k = want_ids.shape[-1]
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    distinct = (np.diff(top, axis=-1) < 0).all(-1)
    assert distinct.any()
    np.testing.assert_array_equal(host(got_ids)[distinct],
                                  want_ids[distinct])


# ---------------------------------------------------------------------------
# moe_ffn against the reference
# ---------------------------------------------------------------------------

# (T, D, F, E, top_k, capacity_factor)
FFN_CASES = {
    "top2": (32, 16, 24, 8, 2, 1.25),
    "top1": (40, 16, 32, 4, 1, 1.25),
    "top8of64": (64, 32, 16, 64, 8, 1.25),
    "drops": (48, 16, 8, 8, 2, 0.5),
    "ample": (48, 16, 8, 8, 2, 8.0),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference(case, dtype):
    T, D, F, E, top_k, cf = FFN_CASES[case]
    tdt, jdt = DTYPES[dtype]
    ref_p = _ref_params(D, F, E, seed=len(case))
    x = np.random.default_rng(3).standard_normal((T, D)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    want, want_aux = _ref_moe_ffn(ref_p, xj, top_k, cf)
    got, aux = moe.moe_ffn(_port(ref_p), torch.from_numpy(x).to(tdt),
                           top_k, cf)
    assert got.dtype == tdt
    probs, want_ids = _ref_expert_ids(xj, ref_p.router, top_k, True)
    _close(torch.softmax(aux["router_logits"], -1), probs)
    if dtype == "float32":
        _assert_ids_where_distinct(aux["expert_ids"], probs, want_ids)
    else:
        np.testing.assert_array_equal(host(aux["expert_ids"]), want_ids)
    _close(got, want, dtype)
    _scalar(aux["aux_loss"], want_aux["aux_loss"])
    _scalar(aux["drop_rate"], want_aux["drop_rate"])
    if case == "drops":
        assert float(aux["drop_rate"]) > 0.1
    if case == "ample":
        assert float(aux["drop_rate"]) == 0.0


def test_moe_ffn_router_ties_rank_the_lower_expert_first():
    """An all-zero router gives every expert the same probability: both
    packages route every token to experts 0..k-1 with equal gates, and
    capacity drops the later tokens."""
    T, D, F, E, top_k = 24, 16, 8, 8, 2
    ref_p = _ref_params(D, F, E, seed=9)._replace(
        router=jnp.zeros((D, E), jnp.float32))
    x = np.random.default_rng(4).standard_normal((T, D)).astype(np.float32)
    want, want_aux = _ref_moe_ffn(ref_p, jnp.asarray(x), top_k, 1.25)
    got, aux = moe.moe_ffn(_port(ref_p), torch.from_numpy(x), top_k, 1.25)
    np.testing.assert_array_equal(
        host(aux["expert_ids"]), np.tile(np.arange(top_k), (T, 1)))
    _close(got, want)
    _scalar(aux["aux_loss"], want_aux["aux_loss"])
    _scalar(aux["drop_rate"], want_aux["drop_rate"])
    assert float(aux["drop_rate"]) > 0


def test_init_moe_shapes_and_scale():
    p = moe.init_moe(torch.Generator().manual_seed(0), 32, 48, 8, "cpu")
    ref = _ref_params(32, 48, 8, 0)
    for got, want in zip(p, ref):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.float32
    # LeCun-normal over the fan-in: the second-to-last axis
    assert abs(float(p.w_down.std()) * 48 ** 0.5 - 1) < 0.05
    assert abs(float(p.w_gate.std()) * 32 ** 0.5 - 1) < 0.05


# ---------------------------------------------------------------------------
# MeshRules and the partition specs
# ---------------------------------------------------------------------------


def test_mesh_rules_defaults_and_resolve():
    assert DEFAULT_RULES == MeshRules()
    for f in ("dp", "tp", "fsdp", "sp"):
        assert getattr(MeshRules(), f) == getattr(RefRules(), f)
    r = MeshRules()
    assert r.resolve("dp", "tp", mesh=None) == ()
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert r.resolve("dp", None, "tp", "fsdp", "sp", mesh=mesh) == \
        ("data", None, "model", "data", "model")
    pod = make_mesh((2, 2), ("pod", "data"), ["cpu"] * 4)
    assert r.resolve("dp", "tp", mesh=pod) == (("pod", "data"), None)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch_id", ["gemma-2b", "olmoe-1b-7b"])
def test_param_specs_equal_the_reference(arch_id, mode):
    cfg = get_arch(arch_id).make_smoke_config()
    got = transformer.param_specs(cfg, MeshRules(), mode)
    want = ref_tf.param_specs(ref_get_arch(arch_id).make_smoke_config(),
                              RefRules(), mode)
    flat_got = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda t: isinstance(t, tuple))
    flat_want = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda t: isinstance(t, P))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g == tuple(w), path
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    for (path, spec), (_, t) in zip(
            flat_got, jax.tree_util.tree_leaves_with_path(params)):
        assert len(spec) == t.dim(), path


# ---------------------------------------------------------------------------
# the mesh cases: the reference in one 8-device subprocess
# ---------------------------------------------------------------------------

MESHES = {"1x4": (1, 4), "2x4": (2, 4), "2x2": (2, 2)}
# (mesh, B, S, D, F, E, top_k, capacity_factor, dtype): B = 3 is the batch
# the 2-row dp axis does not divide
EP_CASES = {
    "1x4_top2": ("1x4", 4, 8, 32, 48, 8, 2, 1.25, "float32"),
    "2x4_top2": ("2x4", 4, 8, 32, 48, 8, 2, 1.25, "float32"),
    "2x4_drops": ("2x4", 8, 32, 32, 48, 8, 2, 1.0, "float32"),
    "2x4_b3": ("2x4", 3, 8, 32, 48, 8, 2, 1.25, "float32"),
    "2x2_top8of64": ("2x2", 4, 16, 32, 16, 64, 8, 1.25, "float32"),
    "1x4_top1": ("1x4", 2, 16, 32, 64, 4, 1, 1.25, "float32"),
    "2x4_bf16": ("2x4", 4, 8, 32, 48, 8, 2, 1.25, "bfloat16"),
}
HEAD_CASES = {"1x4": ("1x4", 512), "2x4": ("2x4", 512),
              "2x2_ragged": ("2x2", 510), "2x4_ragged": ("2x4", 510)}
HEAD_K = 7
LM_CASES = {"olmoe_1x4": ("olmoe-1b-7b", "1x4"),
            "olmoe_2x2": ("olmoe-1b-7b", "2x2"),
            "llama4_1x4": ("llama4-scout-17b-a16e", "1x4")}
LM_B, LM_S = 2, 20
SPEC_CASES = [(m, b, s) for m in ("1x4", "2x4") for b in (1, 8)
              for s in (64, 30)]

REFERENCE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_moe as t
from repro.configs import get_arch
from repro.models import moe, transformer as tf
from repro.models.common import MeshRules

out = {{}}
meshes = {{name: jax.make_mesh(shape, ("data", "model"),
                               axis_types=(jax.sharding.AxisType.Auto,) * 2,
                               devices=jax.devices()[:int(np.prod(shape))])
          for name, shape in t.MESHES.items()}}
for name, (m, B, S, D, F, E, k, cf, dt) in t.EP_CASES.items():
    p = moe.init_moe(jax.random.PRNGKey(len(name)), D, F, E)
    h = np.random.default_rng(len(name)).standard_normal((B, S, D)
                                                         ).astype(np.float32)
    for f, a in zip(p._fields, p):
        out[f"{{name}}/{{f}}"] = np.asarray(a)
    out[f"{{name}}/h"] = h
    with jax.set_mesh(meshes[m]):
        o, aux = jax.jit(lambda p, x: moe.moe_ffn_ep(
            p, x, k, cf, rules=MeshRules()))(p, jnp.asarray(
                h, getattr(jnp, dt)))
    out[f"{{name}}/out"] = np.asarray(o, np.float32)
    for key in ("aux_loss", "drop_rate"):
        out[f"{{name}}/{{key}}"] = np.asarray(aux[key])

for name, (m, V) in t.HEAD_CASES.items():
    rng = np.random.default_rng(len(name))
    h = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, V)).astype(np.float32)
    w[:, 5] = w[:, 300]                          # a tie across shards
    out[f"head_{{name}}/h"], out[f"head_{{name}}/w"] = h, w
    with jax.set_mesh(meshes[m]):
        v, i = tf.topk_logits(jnp.asarray(h), jnp.asarray(w), t.HEAD_K,
                              MeshRules())
    out[f"head_{{name}}/vals"], out[f"head_{{name}}/ids"] = map(np.asarray,
                                                               (v, i))

for name, (arch, m) in t.LM_CASES.items():
    cfg = get_arch(arch).make_smoke_config()
    import dataclasses
    cfg = dataclasses.replace(cfg, compute_dtype=jnp.float32)
    params = tf.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (t.LM_B, t.LM_S + 1),
                                             dtype=np.int32)
    prompt, nxt = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, -1:])
    with jax.set_mesh(meshes[m]):
        hid, aux = jax.jit(lambda p, x: tf.forward(p, x, cfg, MeshRules()))(
            params, prompt)
        last, cache = jax.jit(lambda p, x: tf.prefill(
            p, x, cfg, MeshRules(), cache_dtype=jnp.float32))(params, prompt)
        full = {{key: jnp.zeros((cfg.n_layers, t.LM_B, t.LM_S + 2)
                               + c.shape[3:], jnp.float32)
                .at[:, :, :t.LM_S].set(c) for key, c in cache.items()}}
        (v, i), _ = jax.jit(lambda p, c, x: tf.serve_step(
            p, c, x, t.LM_S, cfg, MeshRules(), top_k=8))(params, full, nxt)
    out[f"lm_{{name}}/tokens"] = toks
    for key, a in (("hidden", hid), ("aux", aux), ("last", last),
                   ("k", cache["k"]), ("v", cache["v"]), ("vals", v),
                   ("ids", i)):
        out[f"lm_{{name}}/{{key}}"] = np.asarray(a)

specs = []
cfg = get_arch("olmoe-1b-7b").make_smoke_config()
for m, b, s in t.SPEC_CASES:
    with jax.set_mesh(meshes[m]):
        sp = tf.kv_cache_specs(cfg, MeshRules(), b, s)
    specs.append({{key: [e if e is None or isinstance(e, str) else list(e)
                        for e in spec] for key, spec in sp.items()}})
out["kv_specs"] = np.asarray(json.dumps(specs))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference mesh result, from one 8-device subprocess."""
    path = tmp_path_factory.mktemp("moe") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    code = REFERENCE.format(tests=os.path.join(REPO, "tests"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                        str(path)], capture_output=True, text=True,
                       timeout=400, env=env, cwd=REPO)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def cpu_mesh(name):
    shape = MESHES[name]
    return make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


@pytest.mark.parametrize("case", sorted(EP_CASES))
def test_moe_ffn_ep_matches_reference(ref, case):
    m, B, S, D, F, E, k, cf, dtype = EP_CASES[case]
    tdt = DTYPES[dtype][0]
    p = moe.MoEParams(*(torch.from_numpy(ref[f"{case}/{f}"])
                        for f in moe.MoEParams._fields))
    h = torch.from_numpy(ref[f"{case}/h"]).to(tdt)
    got, aux = moe.moe_ffn_ep(p, h, k, cf, rules=MeshRules(),
                              mesh=cpu_mesh(m))
    assert got.dtype == tdt and got.shape == (B, S, D)
    _close(got, ref[f"{case}/out"], dtype)
    _scalar(aux["aux_loss"], ref[f"{case}/aux_loss"])
    _scalar(aux["drop_rate"], ref[f"{case}/drop_rate"])
    assert aux["expert_ids"].shape == (B * S, k)
    # the routing, as the reference's EP path routes (compute-dtype logits)
    jdt = DTYPES[dtype][1]
    dp = MESHES[m][0] if B % MESHES[m][0] == 0 else 1
    xj = jnp.asarray(ref[f"{case}/h"], jdt).reshape(dp, -1, D)
    probs, want_ids = _ref_expert_ids(xj, jnp.asarray(ref[f"{case}/router"]),
                                      k, False)
    want_ids, probs = want_ids.reshape(B * S, k), probs.reshape(B * S, E)
    _close(torch.softmax(aux["router_logits"], -1), probs)
    if dtype == "float32":
        _assert_ids_where_distinct(aux["expert_ids"], probs, want_ids)
    else:
        np.testing.assert_array_equal(host(aux["expert_ids"]), want_ids)
    if case == "2x4_drops":
        assert float(aux["drop_rate"]) > 0


def test_moe_ffn_ep_without_drops_equals_moe_ffn():
    """With ample capacity the EP dispatch computes ``moe_ffn``'s output
    at fp32 (each token's experts run once, on one shard each), on every
    mesh shape, a dp-indivisible batch included."""
    ref_p = _ref_params(32, 48, 8, 0)
    p = _port(ref_p)
    for B in (4, 3):
        h = torch.from_numpy(np.random.default_rng(B).standard_normal(
            (B, 8, 32)).astype(np.float32))
        want, want_aux = moe.moe_ffn(p, h.reshape(-1, 32), 2, 8.0)
        for name in MESHES:
            got, aux = moe.moe_ffn_ep(p, h, 2, 8.0, mesh=cpu_mesh(name))
            _close(got.reshape(-1, 32), want)
            assert float(aux["drop_rate"]) == 0.0
            np.testing.assert_array_equal(host(aux["expert_ids"]),
                                          host(want_aux["expert_ids"]))


def test_ep_available():
    rules = MeshRules()
    assert not moe.ep_available(8, rules, None)
    assert moe.ep_available(8, rules, cpu_mesh("2x4"))
    assert not moe.ep_available(6, rules, cpu_mesh("2x4"))
    data_only = make_mesh((4,), ("data",), ["cpu"] * 4)
    assert not moe.ep_available(8, rules, data_only)
    p = _port(_ref_params(16, 8, 6, 0))
    with pytest.raises(ValueError, match="divides the 6 experts"):
        moe.moe_ffn_ep(p, torch.zeros((2, 3, 16)), 2, mesh=cpu_mesh("2x4"))


@pytest.mark.parametrize("shape,devices", [
    ((1, 4), ["cpu", "meta", "cpu", "meta"]),
    ((2, 2), ["cpu", "meta", "meta", "cpu"]),
])
def test_ep_and_sharded_head_refuse_interleaved_devices(shape, devices):
    """A mesh whose device list interleaves two devices gives a device
    (dp row, tp shard) pairs that are no contiguous grid: the EP dispatch
    refuses it rather than run a layout no test covers, and so does the
    sharded head where a device's vocab shards are no contiguous run (the
    ``(1, 4)`` mesh; on the ``(2, 2)`` one each device holds one)."""
    mesh = make_mesh(shape, ("data", "model"), devices)
    p = _port(_ref_params(16, 8, 8, 0))
    with pytest.raises(ValueError, match="not a contiguous grid"):
        moe.moe_ffn_ep(p, torch.zeros((2, 3, 16)), 2, mesh=mesh)
    if shape == (1, 4):
        with pytest.raises(ValueError, match="not a contiguous run"):
            transformer.topk_logits(torch.zeros((2, 16)),
                                    torch.ones((16, 64)), 4, MeshRules(),
                                    mesh=mesh)


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_sharded_topk_logits_matches_reference_and_unsharded(ref, case):
    """The vocab-sharded head (or, where tp does not divide V, its
    fallback) against the reference's on the same mesh shape, and id for
    id against the unsharded head on the same hidden state. Columns 5 and
    300 tie across shards: the lower id ranks first."""
    m, V = HEAD_CASES[case]
    h = torch.from_numpy(ref[f"head_{case}/h"])
    w = torch.from_numpy(ref[f"head_{case}/w"])
    vals, ids = transformer.topk_logits(h, w, HEAD_K, MeshRules(),
                                        mesh=cpu_mesh(m))
    assert ids.dtype == torch.int32
    _close(vals, ref[f"head_{case}/vals"])
    np.testing.assert_array_equal(host(ids), ref[f"head_{case}/ids"])
    uv, ui = transformer.topk_logits(h, w, HEAD_K)
    np.testing.assert_array_equal(host(ids), host(ui))
    _close(vals, uv)


@pytest.mark.parametrize("name", ["1x4", "2x4", "2x2"])
def test_sharded_topk_logits_ties_give_the_lowest_ids(name):
    """An all-ones ``unembed``: every logit ties, so the head returns
    ids 0..k-1, sharded or not, with k past a shard's width too."""
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 16)).astype(np.float32))
    w = torch.ones((16, 64))
    for k in (5, 20):
        _, ids = transformer.topk_logits(h, w, k, MeshRules(),
                                         mesh=cpu_mesh(name))
        np.testing.assert_array_equal(host(ids), np.tile(np.arange(k),
                                                         (3, 1)))


def test_kv_cache_specs_equal_the_reference(ref):
    want = json.loads(str(ref["kv_specs"]))
    cfg = get_arch("olmoe-1b-7b").make_smoke_config()
    for (m, b, s), w in zip(SPEC_CASES, want):
        got = transformer.kv_cache_specs(cfg, MeshRules(), b, s,
                                         mesh=cpu_mesh(m))
        for key in ("k", "v"):
            assert [list(e) if isinstance(e, tuple) else e
                    for e in got[key]] == w[key], (m, b, s)
    assert transformer.kv_cache_specs(cfg, MeshRules(), 8, 64) == {
        "k": (None,) * 5, "v": (None,) * 5}


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_moe_lm_under_a_mesh_matches_reference(ref, case):
    """``forward`` (hidden and summed aux loss), ``prefill`` and a
    ``serve_step`` through the sharded top-8 head, at fp32, with EP on
    the mesh, over the reference's parameters; then the port's decode
    path against its own ``forward`` under the same mesh, drop-free."""
    arch, m = LM_CASES[case]
    import dataclasses
    ref_cfg = dataclasses.replace(ref_get_arch(arch).make_smoke_config(),
                                  compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_arch(arch).make_smoke_config(),
                              compute_dtype=torch.float32)
    params = params_from_reference(jax.tree_util.tree_map(
        np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))),
        device="cpu")
    mesh = cpu_mesh(m)
    key = f"lm_{case}"
    toks = torch.from_numpy(ref[f"{key}/tokens"])
    prompt, nxt = toks[:, :-1], toks[:, -1:]
    stats = []
    hid, aux = transformer.forward(params, prompt, cfg, MeshRules(), mesh,
                                   moe_aux=stats)
    assert len(stats) == cfg.n_layers
    _close(hid, ref[f"{key}/hidden"])
    np.testing.assert_allclose(float(aux), float(ref[f"{key}/aux"]),
                               rtol=SCALAR_RTOL)
    last, cache = transformer.prefill(params, prompt, cfg, MeshRules(),
                                      cache_dtype=torch.float32, mesh=mesh)
    _close(last, ref[f"{key}/last"])
    for kv in ("k", "v"):
        _close(cache[kv], ref[f"{key}/{kv}"])
    full = transformer.init_kv_cache(cfg, LM_B, LM_S + 2,
                                     dtype=torch.float32, device="cpu")
    for kv in ("k", "v"):
        full[kv][:, :, :LM_S] = cache[kv]
    (vals, ids), _ = transformer.serve_step(params, full, nxt, LM_S, cfg,
                                            MeshRules(), top_k=8, mesh=mesh)
    _close(vals, ref[f"{key}/vals"])
    np.testing.assert_array_equal(host(ids), ref[f"{key}/ids"])
    # the port against itself, without drops (the step's capacity differs
    # from the forward's)
    free = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.moe_top_k)
    seq = torch.cat([prompt, nxt], dim=1)
    want, _ = transformer.forward(params, seq, free, MeshRules(), mesh)
    full = transformer.init_kv_cache(cfg, LM_B, LM_S + 2,
                                     dtype=torch.float32, device="cpu")
    _, pre = transformer.prefill(params, prompt, free, MeshRules(),
                                 cache_dtype=torch.float32, mesh=mesh)
    for kv in ("k", "v"):
        full[kv][:, :, :LM_S] = pre[kv]
    before = topk_mips.launches
    got = transformer.decode_hidden(params, full, nxt, LM_S, free,
                                    MeshRules(), mesh)
    _close(got, host(want[:, -1]))
    assert topk_mips.launches == before
