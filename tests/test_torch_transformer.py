"""Parity of the port's LM serving path (dense and MoE, without a mesh;
the mesh cases are ``tests/test_torch_moe.py``'s) with the JAX reference,
on the CPU: RoPE, blocked and decode attention, ``rms_norm``,
``forward`` (with the MoE configs' summed aux loss), ``prefill``,
``serve_step`` with and without the exact top-K head, the cache clamp,
parameter counts, the five LM configs and ``lm_batches``.

The reference's parameters (``init_params`` with ``PRNGKey(0)``) cross to
the port through ``convert.transformer_params_from_reference``, so both
packages compute over the identical state; inputs come from numpy seeds.

Tolerances. At ``compute_dtype = float32`` both packages run the same
fp32 arithmetic in other summation orders (XLA:CPU against PyTorch's CPU
kernels): about 2e-6 measured on values of magnitude ~4 over 2-3 layers,
so 1e-5 relative plus 1e-5 absolute, and ids equal id for id. At bf16
(8 significant bits, 2**-8 relative a rounding) the packages round at
different points (XLA:CPU fuses chains of bf16 elementwise ops in fp32;
PyTorch rounds after each op): the worst measured difference is 1.3% of
the compared tensor's largest magnitude, so values agree within
``BF16_TOL`` = 3% of it, and top-K ids are compared at the slots whose
logit stands more than that tolerance from its neighbours (the (k+1)-th
logit included). A wrong head mapping, scale, mask or position gives
errors of the order of the values themselves. RoPE, ``rms_norm`` and
decode attention compute in fp32 in both packages and round to bf16 at the
same points: at bf16 they came out identical, and are held within
``BF16_ONCE``, 2**-9 of the largest magnitude (half a bf16 ulp of it).
Decode scores taken in bf16, where the reference takes them in fp32, miss
that by 1.5-2x (0.30-0.41% measured). The MoE smoke configs route every
token to the same experts in both packages at both dtypes here (checked
through ``moe_aux``), so they are held to the same tolerances; their
aux loss is within 1e-5 relative at fp32 and ``BF16_TOL`` relative at
bf16 (the router's probabilities come from hidden states that differ by
bf16 roundings).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data.synthetic import lm_batches as ref_lm_batches
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tf
from repro.models.common import count_params as ref_count_params
from repro.models.common import rms_norm as ref_rms_norm
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.convert import transformer_params_from_reference
from repro_torch.data.synthetic import lm_batches
from repro_torch.kernels.topk_mips import topk_mips
from repro_torch.launch.dryrun import REPLACED
from repro_torch.models import attention, transformer
from repro_torch.models.common import cast_tree, count_params, rms_norm

from _torch_parity import host

RTOL = ATOL = 1e-5
BF16_TOL = 3e-2
BF16_ONCE = 2.0 ** -9
DENSE = ("deepseek-67b", "gemma-2b", "stablelm-3b")
ALL_LM = DENSE + ("llama4-scout-17b-a16e", "olmoe-1b-7b")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ONCE = {"float32": "float32", "bfloat16": "bf16_once"}
B, S = 2, 40        # S: not a multiple of the smoke configs' kv_block 32


def _close(got, want, dtype="float32"):
    """Within the tolerance of ``dtype``: "float32", "bfloat16", or
    "bf16_once" (fp32 arithmetic rounded to bf16 at the same points)."""
    got = host(got.float() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    elif dtype == "bf16_once":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_ONCE * np.abs(want).max())
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_TOL * np.abs(want).max())


def _ids_agree(got, want_logits, k, dtype):
    """``got = (values, ids)`` against the reference's full logits: values
    close, ids equal wherever the reference's logit is clear of its
    neighbours (every slot at fp32)."""
    want_vals, want_ids = jax.lax.top_k(jnp.asarray(want_logits, jnp.float32),
                                        k + 1)
    want_vals, want_ids = np.asarray(want_vals), np.asarray(want_ids)
    _close(got[0], want_vals[:, :k], dtype)
    ids = host(got[1])
    assert ids.dtype == np.int32
    if dtype == "float32":
        np.testing.assert_array_equal(ids, want_ids[:, :k])
        return
    tol = BF16_TOL * np.abs(want_vals).max()
    gaps = np.abs(np.diff(want_vals, axis=1))                # [B, k]
    before = np.concatenate([np.full((len(gaps), 1), np.inf), gaps[:, :-1]],
                            axis=1)
    clear = (gaps > tol) & (before > tol)
    np.testing.assert_array_equal(ids[clear], want_ids[:, :k][clear])


def _configs(arch_id, dtype):
    tdt, jdt = DTYPES[dtype]
    ref_cfg = dataclasses.replace(ref_get_arch(arch_id).make_smoke_config(),
                                  compute_dtype=jdt)
    cfg = dataclasses.replace(get_arch(arch_id).make_smoke_config(),
                              compute_dtype=tdt)
    return ref_cfg, cfg


def _params(ref_cfg):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    host_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_params, transformer_params_from_reference(host_params,
                                                         device="cpu")


def _first_flips(stats, ref_params, ref_cfg, prompt, dtype):
    """Where the port's ``forward`` routed a token to another expert set
    than the reference's: each row's first such position (``S`` where
    none). (Two near-equal experts swapped in rank leave the set, and the
    output up to summation order, as they are.)

    The reference's routing is recomputed layer by layer over its own
    residual stream (its ``_attention_block``, ``rms_norm`` and fp32
    router top-k). At fp32 every token must route alike. At bf16 the two
    packages' FFN inputs differ by bf16 roundings, so a token whose k-th
    and (k+1)-th router logits stand within ``BF16_TOL`` of its largest
    may flip; each row's first flip must be such a near-tie, and at least
    half of the positions must precede their row's first flip. A flip
    changes its token's hidden state, and through attention every later
    position's, so the caller compares positions before it only (and the
    last position's hidden state of rows without a flip: llama4's smoke
    config at bf16 flips both rows at position 30, on logit gaps of 0.007
    and 0.004, so its prefill's last state is compared at fp32 only)."""
    assert len(stats) == ref_cfg.n_layers
    Bp, Sp = prompt.shape
    k = ref_cfg.moe_top_k
    dt = ref_cfg.compute_dtype
    x = ref_params["embed"].astype(dt)[jnp.asarray(prompt)]
    positions = jnp.arange(Sp)
    first = np.full(Bp, Sp)
    for i, aux in enumerate(stats):
        lp = jax.tree_util.tree_map(lambda a: a[i], ref_params["layers"])
        attn, _ = ref_tf._attention_block(lp, x, ref_cfg, ref_tf.MeshRules(),
                                          positions)
        x = x + attn
        h = ref_rms_norm(x, lp["ln2"], ref_cfg.norm_eps)
        logits = np.asarray(h.reshape(-1, h.shape[-1]).astype(jnp.float32)
                            @ lp["router"])
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
        flip = (np.sort(host(aux["expert_ids"]), -1)
                != np.sort(np.asarray(ids), -1)).any(-1)
        flip = flip.reshape(Bp, Sp)
        if dtype == "float32":
            assert not flip.any(), f"layer {i}: a token routed otherwise"
        top = -np.sort(-logits, axis=-1)[:, :k + 1].reshape(Bp, Sp, k + 1)
        near = (-np.diff(top, axis=-1)).min(-1) \
            <= BF16_TOL * np.abs(top).max(-1)
        for b in range(Bp):
            hit = np.flatnonzero(flip[b])
            if hit.size and hit[0] < first[b]:
                assert near[b, hit[0]], (i, b, hit[0])
                first[b] = hit[0]
        ffn, _ = ref_tf._ffn_block(lp, x, ref_cfg, ref_tf.MeshRules())
        x = x + ffn
    assert first.sum() >= Bp * Sp / 2
    return [int(f) for f in first]


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# attention and norms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope_matches_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 1000
    want = ref_attn.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 500.0)
    got = attention.apply_rope(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(pos), 500.0)
    assert got.dtype == tdt
    _close(got, want, ONCE[dtype])
    _close(attention.rope_frequencies(16, 500.0),
           ref_attn.rope_frequencies(16, 500.0))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_norm_matches_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((4, 5, 32))).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    got = rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                   1e-6)
    assert got.dtype == tdt
    _close(got, ref_rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale), 1e-6),
           ONCE[dtype])


# (n_heads, n_kv_heads): MHA, GQA with two KV heads (query head h reads
# KV head h // 2, which Tensor.repeat would get wrong), MQA
HEADS = {"mha": (4, 4), "gqa2": (4, 2), "mqa": (4, 1)}


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_blocked_attention_matches_reference(heads, dtype):
    """A padded last block: 40 positions in blocks of 16."""
    tdt, jdt = DTYPES[dtype]
    H, Hkv = HEADS[heads]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 40, h, 8)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    want = ref_attn.blocked_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True, kv_block=16)
    got = attention.blocked_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=True,
        kv_block=16)
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_matches_reference(heads, dtype):
    """A partly filled cache: rows valid to 5 and 17 of 24 positions, the
    rest garbage that the mask must drop."""
    tdt, jdt = DTYPES[dtype]
    H, Hkv = HEADS[heads]
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, H, 64)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 24, Hkv, 64)).astype(np.float32)
              for _ in range(2))
    valid = np.array([5, 17], np.int32)
    want = ref_attn.decode_attention(
        *(jnp.asarray(a, jdt) for a in (q, kc, vc)),
        cache_len=jnp.asarray(valid))
    got = attention.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, kc, vc)),
        cache_len=torch.from_numpy(valid))
    assert got.dtype == tdt
    _close(got, want, ONCE[dtype])


def test_expand_kv_is_jnp_repeat():
    k = np.random.default_rng(5).standard_normal((1, 3, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        host(attention._expand_kv(torch.from_numpy(k), 6)),
        np.asarray(ref_attn._expand_kv(jnp.asarray(k), 6)))


# ---------------------------------------------------------------------------
# configs, parameters, data
# ---------------------------------------------------------------------------


# the reference's config fields that the port replaced (launch/dryrun.py:
# REPLACED), each with its reason there
REPLACED_FIELDS = {
    key.rsplit(".", 1)[1] for key in REPLACED
    if key.startswith("repro.models.transformer:TransformerConfig.")}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "compute_dtype" and f.name not in REPLACED_FIELDS}


@pytest.mark.parametrize("arch_id", ALL_LM)
def test_lm_configs_equal_the_reference(arch_id):
    spec, ref = get_arch(arch_id), ref_get_arch(arch_id)
    assert (spec.family, spec.source) == (ref.family, ref.source)
    assert spec.family == "lm"
    assert [dataclasses.asdict(s) for s in spec.shapes] == \
        [dataclasses.asdict(s) for s in ref.shapes]
    for make in ("make_config", "make_smoke_config"):
        cfg, ref_cfg = getattr(spec, make)(), getattr(ref, make)()
        assert _fields(cfg) == _fields(ref_cfg)
        assert cfg.compute_dtype == torch.bfloat16
        assert ref_cfg.compute_dtype == jnp.bfloat16
        assert (cfg.q_dim, cfg.kv_dim) == (ref_cfg.q_dim, ref_cfg.kv_dim)


def test_registry_holds_the_dense_lms():
    """The registry holds the five LMs: the three dense ones and the two
    MoE ones, with the reference's full-config counts."""
    lms = {a for a, s in REGISTRY.items() if s.family == "lm"}
    assert set(DENSE) <= lms and lms == set(ALL_LM)
    assert get_arch("gemma-2b").make_config().param_count() == 3_030_460_416
    olmoe = get_arch("olmoe-1b-7b").make_config()
    assert (olmoe.param_count(), olmoe.active_param_count()) == \
        (6_919_096_320, 1_281_951_744)
    scout = get_arch("llama4-scout-17b-a16e").make_config()
    assert (scout.param_count(), scout.active_param_count()) == \
        (101_730_063_360, 11_133_096_960)


@pytest.mark.parametrize("arch_id", ALL_LM)
def test_param_count_matches_reference(arch_id):
    """Full and smoke configs of all five LMs; the smoke config's drawn
    parameters count what ``param_count`` says, MoE layers included."""
    ref = ref_get_arch(arch_id)
    for make in ("make_config", "make_smoke_config"):
        ref_cfg = getattr(ref, make)()
        cfg = transformer.TransformerConfig(**_fields(ref_cfg))
        assert cfg.param_count() == ref_cfg.param_count()
        assert cfg.active_param_count() == ref_cfg.active_param_count()
    params = transformer.init_params(cfg, torch.Generator(), "cpu")
    assert count_params(params) == cfg.param_count()
    assert ("router" in params["layers"]) == cfg.moe


@pytest.mark.parametrize("arch_id", ALL_LM)
def test_init_params_counts_and_layout(arch_id):
    cfg = get_arch(arch_id).make_smoke_config()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    assert count_params(params) == cfg.param_count()
    ref_params = ref_tf.init_params(ref_get_arch(arch_id).make_smoke_config(),
                                    jax.random.PRNGKey(0))
    assert count_params(params) == ref_count_params(ref_params)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref_params)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    served = transformer.serving_params(params, cfg)
    assert served["layers"]["wq"].dtype == torch.bfloat16
    if cfg.moe:   # the experts cast once; the router stays fp32
        for key in ("moe_gate", "moe_up", "moe_down"):
            assert served["layers"][key].dtype == torch.bfloat16
        assert served["layers"]["router"] is params["layers"]["router"]
    for key in ("ln1", "ln2"):
        assert served["layers"][key] is params["layers"][key]
    assert served["unembed"] is params["unembed"]
    assert served["embed"] is params["embed"]
    assert cast_tree(params, torch.bfloat16)["unembed"].dtype == \
        torch.bfloat16


def test_lm_batches_are_the_reference_stream():
    for shard, num_shards in ((0, 1), (1, 2), (3, 4)):
        args = (7, 1000, 8, 33, shard, num_shards)
        for got, want, _ in zip(lm_batches(*args), ref_lm_batches(*args),
                                range(3)):
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch_id", ALL_LM)
def test_model_matches_reference(arch_id, dtype):
    """``forward``, ``prefill`` and two ``serve_step``s (the top-K head,
    then the plain logits) over the same parameters and tokens; for a
    MoE config also ``forward``'s aux loss and every layer's experts."""
    ref_cfg, cfg = _configs(arch_id, dtype)
    ref_params, params = _params(ref_cfg)
    served = transformer.serving_params(params, cfg)
    tdt, cdt = DTYPES[dtype]
    toks = _tokens(cfg.vocab_size, (B, S + 2))
    prompt, nxt = toks[:, :S], toks[:, S:]

    want_h, want_aux = jax.jit(functools.partial(ref_tf.forward,
                                                 config=ref_cfg))(
        ref_params, jnp.asarray(prompt))
    stats = []
    got_h, aux = transformer.forward(params, torch.from_numpy(prompt), cfg,
                                     moe_aux=stats)
    assert got_h.dtype == tdt
    if cfg.moe:
        np.testing.assert_allclose(
            float(aux), float(want_aux),
            rtol=RTOL if dtype == "float32" else BF16_TOL)
        first = _first_flips(stats, ref_params, ref_cfg, prompt, dtype)
    else:
        assert float(aux) == 0.0 and not stats
        first = [S] * B
    # positions before a row's first routing flip see none (causal)
    for b, f in enumerate(first):
        _close(got_h[b, :f], np.asarray(want_h, np.float32)[b, :f], dtype)
    clean = [b for b, f in enumerate(first) if f == S]

    want_last, want_c = jax.jit(functools.partial(
        ref_tf.prefill, config=ref_cfg, cache_dtype=cdt))(
            ref_params, jnp.asarray(prompt))
    got_last, got_c = transformer.prefill(served, torch.from_numpy(prompt),
                                          cfg, cache_dtype=tdt)
    if clean:
        _close(got_last[clean], np.asarray(want_last, np.float32)[clean],
               dtype)
    for key in ("k", "v"):
        assert got_c[key].dtype == tdt
        for b, f in enumerate(first):
            _close(got_c[key][:, b, :f],
                   np.asarray(want_c[key], np.float32)[:, b, :f], dtype)

    # decode from the reference's prefill cache, so both steps start from
    # one state (a row with a routing flip in its prompt too)
    ref_cache = {key: jnp.zeros((cfg.n_layers, B, S + 4) + c.shape[3:], cdt)
                 .at[:, :, :S].set(c) for key, c in want_c.items()}
    cache = {key: torch.from_numpy(np.asarray(c, np.float32)).to(tdt)
             for key, c in ref_cache.items()}
    ref_step = jax.jit(ref_tf.serve_step, static_argnames=("config", "top_k"))
    want_logits, _ = ref_step(ref_params, ref_cache, jnp.asarray(nxt[:, :1]),
                              S, config=ref_cfg)
    (want_v, want_i), ref_cache = ref_step(
        ref_params, ref_cache, jnp.asarray(nxt[:, :1]), S, config=ref_cfg,
        top_k=8)
    got, cache2 = transformer.serve_step(served, cache,
                                         torch.from_numpy(nxt[:, :1]), S,
                                         cfg, top_k=8)
    assert cache2 is cache                        # written in place
    _ids_agree(got, want_logits, 8, dtype)
    _close(got[0], want_v, dtype)
    for key in ("k", "v"):
        _close(cache[key], ref_cache[key], dtype)

    want_logits, _ = ref_step(ref_params, ref_cache, jnp.asarray(nxt[:, 1:]),
                              S + 1, config=ref_cfg)
    got_logits, _ = transformer.serve_step(
        params, cache, torch.from_numpy(nxt[:, 1:]), S + 1, cfg)
    assert got_logits.dtype == tdt
    _close(got_logits, want_logits, dtype)


def test_serve_step_clamps_writes_at_the_end_of_the_cache():
    """A step at ``cache_len >= max_len`` writes the last row (the start is
    clamped, as ``dynamic_update_slice`` clamps it) while the position and
    the valid length stay unclamped; a step inside the cache for
    comparison. Decode takes one token a row, as the reference's does."""
    ref_cfg, cfg = _configs("deepseek-67b", "float32")
    ref_params, params = _params(ref_cfg)
    rng = np.random.default_rng(6)
    shape = (cfg.n_layers, B, 10, cfg.n_kv_heads, cfg.head_dim)
    start = {key: rng.standard_normal(shape).astype(np.float32)
             for key in ("k", "v")}
    for cache_len in (9, 10, 13):
        toks = _tokens(cfg.vocab_size, (B, 1), seed=cache_len)
        ref_cache = {key: jnp.asarray(a) for key, a in start.items()}
        cache = {key: torch.from_numpy(a.copy()) for key, a in start.items()}
        (want_v, want_i), ref_cache = ref_tf.serve_step(
            ref_params, ref_cache, jnp.asarray(toks), cache_len, ref_cfg,
            top_k=5)
        got, cache = transformer.serve_step(params, cache,
                                            torch.from_numpy(toks),
                                            cache_len, cfg, top_k=5)
        _close(got[0], want_v)
        np.testing.assert_array_equal(host(got[1]), np.asarray(want_i))
        for key in ("k", "v"):
            _close(cache[key], ref_cache[key])
            # rows before the clamped start are untouched
            first = min(cache_len, 9)
            np.testing.assert_array_equal(host(cache[key])[:, :, :first],
                                          start[key][:, :, :first])


def test_out_of_range_tokens_are_clamped_as_the_reference_clamps():
    ref_cfg, cfg = _configs("gemma-2b", "float32")
    ref_params, params = _params(ref_cfg)
    V = cfg.vocab_size
    toks = np.array([[-1, V, V + 7, -V - 3, 5, -5]], np.int32)
    want, _ = ref_tf.forward(ref_params, jnp.asarray(toks), ref_cfg)
    got, _ = transformer.forward(params, torch.from_numpy(toks), cfg)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def test_topk_logits_ties_go_to_the_lower_id():
    rng = np.random.default_rng(7)
    hidden = rng.standard_normal((3, 16)).astype(np.float32)
    unembed = rng.standard_normal((16, 50)).astype(np.float32)
    unembed[:, 40] = unembed[:, 3]                 # equal logits, ids 3, 40
    unembed[:, 20] = unembed[:, 30] = unembed[:, 11]
    want = ref_tf.topk_logits(jnp.asarray(hidden), jnp.asarray(unembed), 50)
    got = transformer.topk_logits(torch.from_numpy(hidden),
                                  torch.from_numpy(unembed), 50)
    _close(got[0], want[0])
    np.testing.assert_array_equal(host(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch_id", ALL_LM)
def test_decode_path_matches_forward(arch_id, dtype):
    """The port against itself: ``prefill`` of a prompt, then t greedy
    ``serve_step``s, gives at the last position the hidden state of
    ``forward`` over the whole sequence. The head runs no kernel. A MoE
    config runs drop-free (``capacity_factor = E / top_k``: an expert's
    capacity is every token), because a decode step's capacity (its few
    tokens) is not the forward's and capacity decides what drops."""
    _, cfg = _configs(arch_id, dtype)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.moe_top_k)
    tdt = DTYPES[dtype][0]
    params = transformer.serving_params(transformer.init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu"), cfg)
    prompt, t = torch.from_numpy(_tokens(cfg.vocab_size, (B, 30))), 6
    before = topk_mips.launches
    h, pre = transformer.prefill(params, prompt, cfg, cache_dtype=tdt)
    cache = transformer.init_kv_cache(cfg, B, 30 + t, dtype=tdt,
                                      device="cpu")
    for key in ("k", "v"):
        cache[key][:, :, :30] = pre[key]
    seq = [prompt]
    tok = transformer.topk_logits(h, params["unembed"], 8)[1][:, :1]
    for step in range(t):
        seq.append(tok)
        h = transformer.decode_hidden(params, cache, tok, 30 + step, cfg)
        tok = transformer.topk_logits(h, params["unembed"], 8)[1][:, :1]
    stats = []
    want, _ = transformer.forward(params, torch.cat(seq, dim=1), cfg,
                                  moe_aux=stats)
    _close(h, host(want[:, -1].float()), dtype)
    assert all(float(a["drop_rate"]) == 0.0 for a in stats)
    assert topk_mips.launches == before
