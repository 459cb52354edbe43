"""Decoder-only LM (dense and MoE): the training loss (``loss_fn`` over
``forward`` with per-layer remat and ``chunked_xent``), prefill, the
decode step, the exact top-K vocab head, and the LM's partition specs.

The reference's ``models/transformer.py``: parameters
are its nested dict of tensors with the layers stacked ``[L, ...]`` (the
reference's ``init_params``, or its own tree carried across by
:func:`repro_torch.convert.params_from_reference`), and each
function computes what its namesake there computes, in eager PyTorch on
the parameters' device. Two reads differ in cost, not in value:

* the token rows are gathered first and cast after
  (:func:`repro_torch.models.embedding.index_rows`), where the reference
  casts the whole ``[V, D]`` table and then gathers (so at bf16 the
  table's gradient is summed in fp32, where the reference sums it in
  bf16);
* each projection weight is cast to ``compute_dtype`` when it is read, as
  the reference casts it, but :func:`serving_params` casts the layer
  stack once beforehand, which makes every later cast a no-op: at
  gemma-2b's width the per-step cast would read 7.9 GB of fp32 weights
  and write 4.0 GB of bf16 on every decode step (olmoe-1b-7b's experts:
  26.8 GB read).

:func:`serve_step` writes the new token's keys and values into the cache
IN PLACE and returns the same cache tensors (the reference returns a new
cache).

A MoE config (``moe=True``) runs :func:`repro_torch.models.moe.moe_ffn`
in each layer, or with ``moe_ep`` and a mesh whose tp axis divides the
experts, the expert-parallel :func:`repro_torch.models.moe.moe_ffn_ep`.
The entry points take the reference's ``rules`` and, where the reference
reads the ambient mesh, a ``mesh`` keyword (a
:class:`repro_torch.core.mesh.Mesh`; ``None``, the default, means no
mesh). The mesh changes values only where the reference's does: the EP
dispatch (capacity per dp row) and the vocab-sharded head of
:func:`topk_logits` (the same top-K, merged from the shards'). The
reference's layout constraints have no counterpart (see
:mod:`repro_torch.models.common`). ``moe_aux``, a list, collects each MoE
layer's aux dict (``aux_loss``, ``drop_rate``, ``expert_ids``; tensors,
read by nobody on the path) for a caller that reports them.

Training. :func:`loss_fn` is the reference's: ``forward``'s hidden states
through :func:`chunked_xent`, plus ``aux_loss_weight`` times the summed
MoE aux loss over the layer count. With ``config.remat`` each layer of
:func:`forward` runs under ``torch.utils.checkpoint`` (the non-reentrant
form, which ``torch.autograd.grad`` needs), so only the layers' inputs
are kept for the backward, as the reference's ``jax.checkpoint`` keeps
them; the values are the same either way. Each pass unbinds the stacked
``[L, ...]`` layer weights once (:func:`_layers`): its backward stacks
the L gradients of a leaf once, where indexing ``w[i]`` a layer would
add a zero tensor the size of the whole stack into the gradient for
every layer. The token rows' gradient is
:func:`repro_torch.models.embedding.index_rows`' deterministic fp32 sum.
A MoE config trains through :func:`repro_torch.models.moe.moe_ffn`'s
autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.mesh import Mesh, shard_groups, take_shards
from repro_torch.core.naive import stable_topk
from repro_torch.models.attention import (apply_rope, blocked_attention,
                                          decode_attention)
from repro_torch.models.common import (ACTIVATIONS, DEFAULT_RULES, MeshRules,
                                       cast_tree, dense_init, embed_init,
                                       rms_norm, spec_entry)
from repro_torch.models.embedding import index_rows
from repro_torch.models.moe import MoEParams, ep_available, moe_ffn, moe_ffn_ep

# the layer weights that enter a matmul in the compute dtype (the norms'
# scales stay fp32, and so does the MoE router: moe_ffn routes in fp32)
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "moe_gate", "moe_up", "moe_down")


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
    moe_ep: bool = True   # expert-parallel dispatch under a mesh
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


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(config: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random fp32 parameters drawn from ``generator``, which must live on
    ``device`` (``None`` = ``cuda``): a full-width model is drawn on the
    card and never crosses the host. A MoE config's layers hold
    ``router [L, D, E]``, ``moe_gate``/``moe_up [L, E, D, F]`` and
    ``moe_down [L, E, F, D]`` in place of the dense FFN."""
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
    }
    if config.moe:
        E, F = config.n_experts, config.moe_d_ff
        layers["router"] = dense_init(generator, (L, D, E))
        layers["moe_gate"] = dense_init(generator, (L, E, D, F))
        layers["moe_up"] = dense_init(generator, (L, E, D, F))
        layers["moe_down"] = dense_init(generator, (L, E, F, D))
    else:
        layers["w_gate"] = dense_init(generator, (L, D, config.d_ff))
        layers["w_up"] = dense_init(generator, (L, D, config.d_ff))
        layers["w_down"] = dense_init(generator, (L, config.d_ff, D))
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
    cast = cast_tree({key: layers[key] for key in PROJECTIONS
                      if key in layers}, config.compute_dtype)
    return {**params, "layers": {**layers, **cast}}


def param_specs(config: TransformerConfig, rules: MeshRules,
                mode: str = "train") -> Dict:
    """Partition specs matching :func:`init_params`, one tuple a tensor
    (entry for entry the reference's ``PartitionSpec``). ``mode="serve"``
    drops FSDP (the batch owns the data axis at inference)."""
    tp = rules.tp
    fsdp = rules.fsdp if mode == "train" else None
    layers = {
        "ln1": (None, None),
        "ln2": (None, None),
        "wq": (None, fsdp, tp),
        "wk": (None, fsdp, tp),
        "wv": (None, fsdp, tp),
        "wo": (None, tp, fsdp),
    }
    if config.moe:
        layers["router"] = (None, fsdp, None)
        layers["moe_gate"] = (None, tp, fsdp, None)
        layers["moe_up"] = (None, tp, fsdp, None)
        layers["moe_down"] = (None, tp, None, fsdp)
    else:
        layers["w_gate"] = (None, fsdp, tp)
        layers["w_up"] = (None, fsdp, tp)
        layers["w_down"] = (None, tp, fsdp)
    return {
        "embed": (tp, fsdp),
        "layers": layers,
        "final_norm": (None,),
        "unembed": (fsdp, tp),
    }


def _layers(params: Dict) -> List[Dict]:
    """Each layer's weights, a dict of ``[...]`` tensors a layer: every
    stacked ``[L, ...]`` leaf unbound once (see the module docstring)."""
    cols = {key: torch.unbind(w, 0) for key, w in params["layers"].items()}
    n = len(next(iter(cols.values())))
    return [{key: col[i] for key, col in cols.items()} for i in range(n)]


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


def _ffn_block(lp: Dict, x: torch.Tensor, config: TransformerConfig,
               rules: MeshRules, mesh: Optional[Mesh],
               moe_aux: Optional[List] = None):
    """The gated feed-forward of ``x [B, S, D]`` (dense, or the MoE's):
    ``(out [B, S, D], aux_loss)``, ``aux_loss`` 0.0 for a dense layer."""
    dt = config.compute_dtype
    h = rms_norm(x, lp["ln2"], config.norm_eps)
    if config.moe:
        params = MoEParams(router=lp["router"], w_gate=lp["moe_gate"],
                           w_up=lp["moe_up"], w_down=lp["moe_down"])
        if config.moe_ep and ep_available(config.n_experts, rules, mesh):
            out, aux = moe_ffn_ep(params, h, config.moe_top_k,
                                  config.capacity_factor, config.act, rules,
                                  mesh)
        else:
            B, S, D = h.shape
            out, aux = moe_ffn(params, h.reshape(B * S, D),
                               config.moe_top_k, config.capacity_factor,
                               config.act, rules)
            out = out.reshape(B, S, D)
        if moe_aux is not None:
            moe_aux.append(aux)
        return out, aux["aux_loss"]
    act = ACTIVATIONS[config.act]
    g = h @ lp["w_gate"].to(dt)
    u = h @ lp["w_up"].to(dt)
    return (act(g) * u) @ lp["w_down"].to(dt), 0.0


def _layer(lp: Dict, x: torch.Tensor, config: TransformerConfig,
           positions: torch.Tensor, rules: MeshRules, mesh: Optional[Mesh],
           kv_cache=None, cache_len=None, moe_aux=None):
    x = x + _attention_block(lp, x, config, positions, kv_cache, cache_len)
    out, aux = _ffn_block(lp, x, config, rules, mesh, moe_aux)
    return x + out, aux


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            rules: MeshRules = DEFAULT_RULES, mesh: Optional[Mesh] = None,
            moe_aux: Optional[List] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward. tokens: ``[B, S]`` -> ``(hidden [B, S, D], aux)``;
    ``aux`` is the MoE load-balancing loss summed over the layers (0 for
    a dense model), fp32. With ``config.remat`` each layer is
    checkpointed (recomputed in the backward; a plain call where
    gradients are off)."""
    S = tokens.shape[1]
    x = _embed(params, tokens, config)
    positions = torch.arange(S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params):
        if config.remat:
            # the recompute appends its aux dict again, to a list no one
            # reads; the first pass's goes to the caller's
            mine = [] if moe_aux is not None else None
            x, a = checkpoint(_layer, lp, x, config, positions, rules, mesh,
                              moe_aux=mine, use_reentrant=False)
            if mine:
                moe_aux.append(mine[0])
        else:
            x, a = _layer(lp, x, config, positions, rules, mesh,
                          moe_aux=moe_aux)
        if config.moe:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return x, aux


def prefill(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
            rules: MeshRules = DEFAULT_RULES,
            cache_dtype: torch.dtype = torch.bfloat16,
            mesh: Optional[Mesh] = None, moe_aux: Optional[List] = None):
    """Prompt ingestion: the forward pass that also emits the stacked KV
    cache (``{"k", "v"}: [L, B, S, Hkv, hd]`` in ``cache_dtype``) and
    returns it with the last position's hidden state ``[B, D]``."""
    B, S = tokens.shape
    dt = config.compute_dtype
    x = _embed(params, tokens, config)
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for lp in _layers(params):
        q, k, v = _qkv(lp, x, config, positions)
        attn = blocked_attention(q, k, v, causal=True,
                                 kv_block=config.kv_block,
                                 q_positions=positions,
                                 kv_positions=positions)
        x = x + attn.reshape(B, S, config.q_dim) @ lp["wo"].to(dt)
        x = x + _ffn_block(lp, x, config, rules, mesh, moe_aux)[0]
        ks.append(k.to(cache_dtype))
        vs.append(v.to(cache_dtype))
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return x[:, -1, :], {"k": torch.stack(ks), "v": torch.stack(vs)}


def logits_from_hidden(params: Dict, hidden: torch.Tensor,
                       config: TransformerConfig) -> torch.Tensor:
    """The full logits ``hidden @ unembed``, in ``hidden``'s dtype."""
    return hidden @ params["unembed"].to(hidden.dtype)


def _chunk_xent(h: torch.Tensor, labels: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The summed cross-entropy of one chunk ``h [B, c, D]``: fp32 logits
    of the compute-dtype product, their logsumexp minus the gold logit. A
    label outside ``[0, V)`` has a gold logit of 0, as the reference's
    one-hot contraction gives it."""
    logits = (h @ w.to(h.dtype)).float()                      # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    valid = (labels >= 0) & (labels < V)
    gold = torch.gather(logits, -1,
                        torch.where(valid, labels, 0).long()[..., None])
    return torch.sum(lse - torch.where(valid, gold[..., 0], 0.0))


def chunked_xent(params: Dict, hidden: torch.Tensor, labels: torch.Tensor,
                 config: TransformerConfig,
                 rules: MeshRules = DEFAULT_RULES) -> torch.Tensor:
    """Mean cross-entropy of ``hidden [B, S, D]`` against ``labels [B, S]``
    without materialising ``[B, S, V]`` logits: the sequence is cut into
    chunks of ``config.logit_chunk`` positions (one chunk of ``S`` when
    that does not divide ``S``), each checkpointed, so its logits live
    only while it runs, in the forward and again in the backward. The
    chunks' sums add in order in fp32, as the reference's scan adds them.
    ``rules`` is the reference's (a layout constraint, no value)."""
    B, S, _ = hidden.shape
    chunk = min(config.logit_chunk, S)
    if S % chunk != 0:
        chunk = S
    w = params["unembed"]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, S, chunk):
        total = total + checkpoint(_chunk_xent, hidden[:, start:start + chunk],
                                   labels[:, start:start + chunk], w,
                                   use_reentrant=False)
    return total / (B * S)


def loss_fn(params: Dict, batch: Dict, config: TransformerConfig,
            rules: MeshRules = DEFAULT_RULES, mesh: Optional[Mesh] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """The training loss of ``batch`` (``tokens``, ``labels``: ``[B, S]``):
    ``xent + aux_loss_weight * aux / max(n_layers, 1)``, and the metrics
    ``{"xent", "aux_loss"}`` (0-d fp32 tensors)."""
    hidden, aux = forward(params, batch["tokens"], config, rules, mesh)
    xent = chunked_xent(params, hidden, batch["labels"], config, rules)
    loss = xent + config.aux_loss_weight * aux / max(config.n_layers, 1)
    return loss, {"xent": xent, "aux_loss": aux}


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


def kv_cache_specs(config: TransformerConfig, rules: MeshRules, batch: int,
                   seq_len: int, mesh: Optional[Mesh] = None) -> Dict:
    """Partition specs of the cache, ``(None, dp, sp, None, None)``: the
    batch over dp and the sequence over sp where they divide. When the
    batch cannot take the data axes (``batch % dp != 0``, e.g. one
    long-context row), the SEQUENCE takes them in front of sp (context
    parallelism over data x model)."""
    dp = sp = None
    if mesh is not None:
        sizes = mesh.shape
        dp_axes = rules.dp_axes(mesh)
        dp_size = math.prod(sizes[a] for a in dp_axes)
        dp = dp_axes if (dp_axes and batch % dp_size == 0) else None
        seq_axes = (rules.sp,) if rules.sp in sizes else ()
        if dp is None and dp_axes:
            seq_axes = dp_axes + tuple(a for a in seq_axes
                                       if a not in dp_axes)
        seq_size = math.prod(sizes[a] for a in seq_axes)
        sp = seq_axes if seq_len % seq_size == 0 else None
        dp, sp = spec_entry(dp or ()), spec_entry(sp or ())
    spec = (None, dp, sp, None, None)
    return {"k": spec, "v": spec}


def decode_hidden(params: Dict, cache: Dict, tokens: torch.Tensor,
                  cache_len: int, config: TransformerConfig,
                  rules: MeshRules = DEFAULT_RULES,
                  mesh: Optional[Mesh] = None,
                  moe_aux: Optional[List] = None) -> torch.Tensor:
    """The decode step of :func:`serve_step` up to its head: tokens
    ``[B, S]`` at positions ``cache_len + [0, S)`` -> the last position's
    hidden state ``[B, D]``. Writes the new keys and values into
    ``cache`` in place."""
    cache_len = int(cache_len)
    S = tokens.shape[1]
    x = _embed(params, tokens, config)
    positions = cache_len + torch.arange(S, device=x.device)
    for i, lp in enumerate(_layers(params)):
        x, _ = _layer(lp, x, config, positions, rules, mesh,
                      kv_cache=(cache["k"][i], cache["v"][i]),
                      cache_len=cache_len, moe_aux=moe_aux)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return x[:, -1, :]


def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor, cache_len,
               config: TransformerConfig, rules: MeshRules = DEFAULT_RULES,
               top_k: int = 0, mesh: Optional[Mesh] = None,
               moe_aux: Optional[List] = None):
    """One decode step. tokens: ``[B, 1]``; ``cache_len``: the number of
    positions already in the cache (an int, the same for every row).
    Returns ``(logits-or-topk, cache)``: the ``[B, V]`` logits in
    ``compute_dtype``, or with ``top_k > 0`` the exact top-K ``(values
    [B, K] fp32, ids [B, K] int32)`` of :func:`topk_logits` (over
    ``mesh``, when one is given). The cache is written in place and
    returned as the same tensors."""
    hidden = decode_hidden(params, cache, tokens, cache_len, config, rules,
                           mesh, moe_aux)
    if top_k <= 0:
        return logits_from_hidden(params, hidden, config), cache
    return topk_logits(hidden, params["unembed"], top_k, rules, mesh), cache


def topk_logits(hidden: torch.Tensor, unembed: torch.Tensor, k: int,
                rules: MeshRules = DEFAULT_RULES,
                mesh: Optional[Mesh] = None):
    """Exact top-K over the vocab: the SEP-LR head, with the vocabulary as
    the catalogue. Returns ``(values [B, k] fp32, ids [B, k] int32)``;
    equal logits rank the lower id first, as ``lax.top_k`` ranks them.

    Without a mesh whose tp axis divides ``V``: one fp32 product of
    ``hidden [B, D]`` with ``unembed [D, V]``, then a stable top-``k``.
    Otherwise the vocab is split into tp shards of ``v_local`` columns
    (the distributed merge of :mod:`repro_torch.core.sharded`): each
    shard's fp32 product and its stable top-``min(k, v_local)``, its ids
    offset by ``shard * v_local``, the shards' candidates concatenated in
    shard order and a final stable top-``k``. A device's shards, which
    must be a contiguous run (``ValueError`` otherwise), are one batched
    product."""
    tp = rules.tp
    V = unembed.shape[1]
    if mesh is None or tp not in mesh.axis_names \
            or V % mesh.shape[tp] != 0:
        logits = hidden.float() @ unembed.float()
        vals, idx = stable_topk(logits, k)
        return vals, idx.to(torch.int32)
    n = mesh.shape[tp]
    v_local = V // n
    w = unembed.reshape(unembed.shape[0], n, v_local)
    lead = hidden.device
    vals: List[Optional[torch.Tensor]] = [None] * n
    ids: List[Optional[torch.Tensor]] = [None] * n
    for g in shard_groups(mesh, (tp,)):
        js = list(g.shards)
        w_g = take_shards(w, js, dim=1).to(g.device).float().permute(
            1, 0, 2)                                            # [J, D, v]
        logits = hidden.to(g.device).float() @ w_g             # [J, B, v]
        v_g, i_g = stable_topk(logits, min(k, v_local))
        i_g = i_g + torch.tensor(js, device=g.device)[:, None, None] \
            * v_local
        for jj, j in enumerate(js):
            vals[j], ids[j] = v_g[jj].to(lead), i_g[jj].to(lead)
    fvals, pos = stable_topk(torch.cat(vals, dim=1), k)
    return fvals, torch.gather(torch.cat(ids, dim=1), 1, pos).to(torch.int32)
