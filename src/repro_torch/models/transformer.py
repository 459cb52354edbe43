"""Decoder-only LM serving: prefill, the decode step and the exact top-K
vocab head.

The dense path of the reference's ``models/transformer.py``: parameters
are its nested dict of tensors with the layers stacked ``[L, ...]`` (the
reference's ``init_params``, or its own tree carried across by
:func:`repro_torch.convert.params_from_reference`), and each
function computes what its namesake there computes, in eager PyTorch on
the parameters' device. Two reads differ in cost, not in value:

* the token rows are gathered first and cast after
  (:func:`repro_torch.models.embedding.index_rows`), where the reference
  casts the whole ``[V, D]`` table and then gathers;
* each projection weight is cast to ``compute_dtype`` when it is read, as
  the reference casts it, but :func:`serving_params` casts the layer
  stack once beforehand, which makes every later cast a no-op: at
  gemma-2b's width the per-step cast would read 7.9 GB of fp32 weights
  and write 4.0 GB of bf16 on every decode step.

:func:`serve_step` writes the new token's keys and values into the cache
IN PLACE and returns the same cache tensors (the reference returns a new
cache). The MoE feed-forward, the LM's sharding (``param_specs``,
``kv_cache_specs``, the vocab-sharded head) and training (``loss_fn``,
``chunked_xent``) are later slices of the port (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.naive import stable_topk
from repro_torch.models.attention import (apply_rope, blocked_attention,
                                          decode_attention)
from repro_torch.models.common import (ACTIVATIONS, cast_tree, dense_init,
                                       embed_init, rms_norm)
from repro_torch.models.embedding import index_rows

# the layer weights that enter a matmul (the norms' scales stay fp32)
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "silu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    moe_ep: bool = True   # expert-parallel dispatch
    # numerics / memory
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    logit_chunk: int = 512
    kv_block: int = 512
    # the reference's roofline-calibration switch (unrolled XLA scans);
    # eager PyTorch has no scan to unroll
    unroll: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers + unembed)."""
        d, l = self.d_model, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.moe:
            ffn = d * self.n_experts + 3 * self.n_experts * d * self.moe_d_ff
        else:
            ffn = 3 * d * self.d_ff
        norms = 2 * d
        return (self.vocab_size * d                      # embed
                + l * (attn + ffn + norms)
                + d                                       # final norm
                + d * self.vocab_size)                    # unembed

    def active_param_count(self) -> int:
        """Active-per-token params (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn = d * self.n_experts + 3 * self.moe_top_k * d * self.moe_d_ff
        return (self.vocab_size * d + l * (attn + ffn + 2 * d)
                + d + d * self.vocab_size)


def _dense_only(config: TransformerConfig) -> None:
    if config.moe:
        raise NotImplementedError(
            f"{config.name}: the MoE feed-forward is not ported yet "
            "(ROADMAP A7, moe.py)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(config: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random fp32 parameters drawn from ``generator``, which must live on
    ``device`` (``None`` = ``cuda``): a full-width model is drawn on the
    card and never crosses the host."""
    _dense_only(config)
    dev = resolve_device(device)
    L, D = config.n_layers, config.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    layers = {
        "ln1": zeros(L, D),
        "ln2": zeros(L, D),
        "wq": dense_init(generator, (L, D, config.q_dim)),
        "wk": dense_init(generator, (L, D, config.kv_dim)),
        "wv": dense_init(generator, (L, D, config.kv_dim)),
        "wo": dense_init(generator, (L, config.q_dim, D)),
        "w_gate": dense_init(generator, (L, D, config.d_ff)),
        "w_up": dense_init(generator, (L, D, config.d_ff)),
        "w_down": dense_init(generator, (L, config.d_ff, D)),
    }
    return {
        "embed": embed_init(generator, (config.vocab_size, D)),
        "layers": layers,
        "final_norm": zeros(D),
        "unembed": dense_init(generator, (D, config.vocab_size)),
    }


def serving_params(params: Dict, config: TransformerConfig) -> Dict:
    """``params`` with the layers' projection weights cast to
    ``compute_dtype`` once. Every function here then reads the same
    values the reference reads (it casts the same weights on each call),
    without the cast. The norms, ``embed`` and ``unembed`` stay as they
    are: the head reads ``unembed`` in fp32."""
    layers = params["layers"]
    cast = cast_tree({key: layers[key] for key in PROJECTIONS},
                     config.compute_dtype)
    return {**params, "layers": {**layers, **cast}}


def _layer_params(params: Dict, i: int) -> Dict:
    return {key: w[i] for key, w in params["layers"].items()}


def _embed(params: Dict, tokens: torch.Tensor,
           config: TransformerConfig) -> torch.Tensor:
    """The token rows, gathered from the fp32 table and then cast."""
    return index_rows(params["embed"], tokens).to(config.compute_dtype)


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------


def _qkv(lp: Dict, x: torch.Tensor, config: TransformerConfig,
         positions: torch.Tensor):
    """The rotated queries and keys, and the values, of ``x``."""
    B, S, _ = x.shape
    dt = config.compute_dtype
    h = rms_norm(x, lp["ln1"], config.norm_eps)
    q = (h @ lp["wq"].to(dt)).reshape(B, S, config.n_heads, config.head_dim)
    k = (h @ lp["wk"].to(dt)).reshape(B, S, config.n_kv_heads,
                                      config.head_dim)
    v = (h @ lp["wv"].to(dt)).reshape(B, S, config.n_kv_heads,
                                      config.head_dim)
    q = apply_rope(q, positions, config.rope_theta)
    k = apply_rope(k, positions, config.rope_theta)
    return q, k, v


def _attention_block(lp: Dict, x: torch.Tensor, config: TransformerConfig,
                     positions: torch.Tensor,
                     kv_cache: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                     cache_len: Optional[int] = None):
    """x: ``[B, S, D]`` -> ``[B, S, D]``. With a cache, the new keys and
    values are first written into it in place at ``cache_len`` (the start
    clamped to ``[0, max_len - S]``, as ``dynamic_update_slice`` clamps
    it)."""
    B, S, _ = x.shape
    dt = config.compute_dtype
    q, k, v = _qkv(lp, x, config, positions)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        start = min(max(cache_len, 0), k_cache.shape[1] - S)
        k_cache[:, start:start + S] = k.to(k_cache.dtype)
        v_cache[:, start:start + S] = v.to(v_cache.dtype)
        valid = torch.full((B,), cache_len + S, dtype=torch.int32,
                           device=x.device)
        attn = decode_attention(q, k_cache.to(dt), v_cache.to(dt),
                                cache_len=valid)
    else:
        attn = blocked_attention(q, k, v, causal=True,
                                 kv_block=config.kv_block,
                                 q_positions=positions,
                                 kv_positions=positions)
    return attn.reshape(B, S, config.q_dim) @ lp["wo"].to(dt)


def _ffn_block(lp: Dict, x: torch.Tensor,
               config: TransformerConfig) -> torch.Tensor:
    """The dense gated feed-forward of ``x``: ``[B, S, D]``."""
    dt = config.compute_dtype
    h = rms_norm(x, lp["ln2"], config.norm_eps)
    act = ACTIVATIONS[config.act]
    g = h @ lp["w_gate"].to(dt)
    u = h @ lp["w_up"].to(dt)
    return (act(g) * u) @ lp["w_down"].to(dt)


def _layer(lp: Dict, x: torch.Tensor, config: TransformerConfig,
           positions: torch.Tensor, kv_cache=None, cache_len=None):
    x = x + _attention_block(lp, x, config, positions, kv_cache, cache_len)
    return x + _ffn_block(lp, x, config)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward(params: Dict, tokens: torch.Tensor,
            config: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward. tokens: ``[B, S]`` -> ``(hidden [B, S, D], aux)``;
    ``aux`` (the MoE load-balancing loss) is 0 for a dense model."""
    _dense_only(config)
    S = tokens.shape[1]
    x = _embed(params, tokens, config)
    positions = torch.arange(S, device=x.device)
    for i in range(config.n_layers):
        x = _layer(_layer_params(params, i), x, config, positions)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            cache_dtype: torch.dtype = torch.bfloat16):
    """Prompt ingestion: the forward pass that also emits the stacked KV
    cache (``{"k", "v"}: [L, B, S, Hkv, hd]`` in ``cache_dtype``) and
    returns it with the last position's hidden state ``[B, D]``."""
    _dense_only(config)
    B, S = tokens.shape
    dt = config.compute_dtype
    x = _embed(params, tokens, config)
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for i in range(config.n_layers):
        lp = _layer_params(params, i)
        q, k, v = _qkv(lp, x, config, positions)
        attn = blocked_attention(q, k, v, causal=True,
                                 kv_block=config.kv_block,
                                 q_positions=positions,
                                 kv_positions=positions)
        x = x + attn.reshape(B, S, config.q_dim) @ lp["wo"].to(dt)
        x = x + _ffn_block(lp, x, config)
        ks.append(k.to(cache_dtype))
        vs.append(v.to(cache_dtype))
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return x[:, -1, :], {"k": torch.stack(ks), "v": torch.stack(vs)}


def logits_from_hidden(params: Dict, hidden: torch.Tensor,
                       config: TransformerConfig) -> torch.Tensor:
    """The full logits ``hidden @ unembed``, in ``hidden``'s dtype."""
    return hidden @ params["unembed"].to(hidden.dtype)


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def init_kv_cache(config: TransformerConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Dict:
    """Zeroed ``{"k", "v"}: [L, batch, max_len, Hkv, hd]`` on ``device``
    (``None`` = ``cuda``)."""
    shape = (config.n_layers, batch, max_len, config.n_kv_heads,
             config.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_hidden(params: Dict, cache: Dict, tokens: torch.Tensor,
                  cache_len: int, config: TransformerConfig) -> torch.Tensor:
    """The decode step of :func:`serve_step` up to its head: tokens
    ``[B, S]`` at positions ``cache_len + [0, S)`` -> the last position's
    hidden state ``[B, D]``. Writes the new keys and values into
    ``cache`` in place."""
    _dense_only(config)
    cache_len = int(cache_len)
    S = tokens.shape[1]
    x = _embed(params, tokens, config)
    positions = cache_len + torch.arange(S, device=x.device)
    for i in range(config.n_layers):
        x = _layer(_layer_params(params, i), x, config, positions,
                   kv_cache=(cache["k"][i], cache["v"][i]),
                   cache_len=cache_len)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return x[:, -1, :]


def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor, cache_len,
               config: TransformerConfig, top_k: int = 0):
    """One decode step. tokens: ``[B, 1]``; ``cache_len``: the number of
    positions already in the cache (an int, the same for every row).
    Returns ``(logits-or-topk, cache)``: the ``[B, V]`` logits in
    ``compute_dtype``, or with ``top_k > 0`` the exact top-K ``(values
    [B, K] fp32, ids [B, K] int32)`` of :func:`topk_logits`. The cache is
    written in place and returned as the same tensors."""
    hidden = decode_hidden(params, cache, tokens, cache_len, config)
    if top_k <= 0:
        return logits_from_hidden(params, hidden, config), cache
    return topk_logits(hidden, params["unembed"], top_k), cache


def topk_logits(hidden: torch.Tensor, unembed: torch.Tensor, k: int):
    """Exact top-K over the vocab: the SEP-LR head, with the vocabulary as
    the catalogue. One fp32 product of ``hidden [B, D]`` with ``unembed
    [D, V]``, then a stable top-``k`` (equal logits rank the lower id
    first, as ``lax.top_k`` ranks them). Returns ``(values [B, k] fp32,
    ids [B, k] int32)``."""
    logits = hidden.float() @ unembed.float()
    vals, idx = stable_topk(logits, k)
    return vals, idx.to(torch.int32)
