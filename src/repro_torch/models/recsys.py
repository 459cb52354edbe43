"""Recsys architectures: FM, DeepFM, DCN-v2, DLRM.

All four share the sparse-embedding substrate
(:mod:`repro_torch.models.embedding`) and one batch layout:

  batch = {"dense": [B, n_dense] float, "sparse": [B, n_sparse] int32}

(tensors, or numpy arrays that are moved to the parameters' device).
Parameters are the reference's nested dict of tensors (``init_params``,
or the reference's own through
:func:`repro_torch.convert.recsys_params_from_reference`).

The FM interaction uses Rendle's O(nk) sum-square identity
  sum_{i<j} <v_i, v_j> x_i x_j = 1/2 * sum_k [(sum_i v_ik x_i)^2 - sum_i v_ik^2 x_i^2]

Where the kernels run: on CUDA tensors the FM interaction (``fm``,
``deepfm``) launches kernel B6 (:mod:`repro_torch.kernels.fm_interaction`),
and the first-order term and the query tower's field mean launch kernel
B5 (:mod:`repro_torch.kernels.embedding_bag`); on CPU tensors both take
their plain versions. DCN-v2 and DLRM run no kernel of their own.

Training: :func:`loss_fn` is the reference's stable BCE-with-logits and
accuracy over :func:`forward` (the batch adds ``"label": [B]``). The
kernels stay in the forward on the card; their gradients are plain
PyTorch behind ``torch.autograd.Function`` (B5's and the field lookup's a
deterministic scatter into a dense table gradient, B6's the closed form),
so a training step differentiates every parameter on either device.
:func:`param_specs` gives the reference's partition specs.

Retrieval goes through the SEP-LR top-K core: the query tower output is
u(x), the candidate item table is T — the paper's model class.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.ops import embedding_bag, fm_interaction
from repro_torch.models.common import (MeshRules, dense_init, mlp_apply,
                                      mlp_params)
from repro_torch.models.embedding import embedding_lookup


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    arch: str                      # fm | deepfm | dcn_v2 | dlrm
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_per_field: int
    mlp_dims: Tuple[int, ...] = ()           # deep tower (deepfm / dcn)
    bot_mlp: Tuple[int, ...] = ()            # dlrm bottom
    top_mlp: Tuple[int, ...] = ()            # dlrm top
    n_cross_layers: int = 0                  # dcn_v2

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field

    @property
    def interaction_input(self) -> int:
        if self.arch == "dcn_v2":
            return self.n_dense + self.n_sparse * self.embed_dim
        if self.arch == "dlrm":
            n = self.n_sparse + 1
            return self.bot_mlp[-1] + n * (n - 1) // 2
        return 0

    def param_count(self) -> int:
        c = self.total_vocab * self.embed_dim
        if self.arch in ("fm", "deepfm"):
            c += self.total_vocab + 1          # linear weights + bias
        if self.arch == "deepfm":
            dims = (self.n_sparse * self.embed_dim,) + self.mlp_dims + (1,)
            c += sum(dims[i] * dims[i+1] + dims[i+1] for i in range(len(dims)-1))
        if self.arch == "dcn_v2":
            d0 = self.interaction_input
            c += self.n_cross_layers * (d0 * d0 + d0)
            dims = (d0,) + self.mlp_dims + (1,)
            c += sum(dims[i] * dims[i+1] + dims[i+1] for i in range(len(dims)-1))
        if self.arch == "dlrm":
            dims = (self.n_dense,) + self.bot_mlp
            c += sum(dims[i] * dims[i+1] + dims[i+1] for i in range(len(dims)-1))
            dims = (self.interaction_input,) + self.top_mlp
            c += sum(dims[i] * dims[i+1] + dims[i+1] for i in range(len(dims)-1))
        return c


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(config: RecsysConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (``None`` = ``cuda``; PyTorch raises otherwise): at
    DeepFM's width the 390 M normals of the embedding table are drawn on
    the card, not on the host."""
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    scale = 1.0 / math.sqrt(config.embed_dim)
    params: Dict = {
        # one logical table: field f owns rows [f*V, (f+1)*V)
        "embed": torch.randn((config.total_vocab, config.embed_dim),
                             generator=generator, device=dev) * scale,
    }
    if config.arch in ("fm", "deepfm"):
        params["linear"] = torch.randn((config.total_vocab,),
                                       generator=generator,
                                       device=dev) * 0.01
        params["bias"] = zeros()
    if config.arch == "deepfm":
        dims = (config.n_sparse * config.embed_dim,) + config.mlp_dims + (1,)
        params["deep"] = mlp_params(generator, dims)
    if config.arch == "dcn_v2":
        d0 = config.interaction_input
        params["cross_w"] = dense_init(generator,
                                       (config.n_cross_layers, d0, d0))
        params["cross_b"] = zeros(config.n_cross_layers, d0)
        dims = (d0,) + config.mlp_dims + (1,)
        params["deep"] = mlp_params(generator, dims)
    if config.arch == "dlrm":
        params["bot"] = mlp_params(generator,
                                   (config.n_dense,) + config.bot_mlp)
        params["top"] = mlp_params(
            generator, (config.interaction_input,) + config.top_mlp)
    return params


def param_specs(config: RecsysConfig, rules: MeshRules,
                mode: str = "train") -> Dict:
    """Partition specs matching :func:`init_params`, one tuple a tensor
    (entry for entry the reference's ``PartitionSpec``): embedding rows
    over tp (DLRM row-parallel), the MLPs replicated (tiny). ``mode`` is
    the reference's, read by no branch."""
    tp = rules.tp
    specs: Dict = {"embed": (tp, None)}

    def mlp(n):
        return [{"w": (None, None), "b": (None,)} for _ in range(n)]

    if config.arch in ("fm", "deepfm"):
        specs["linear"] = (tp,)
        specs["bias"] = ()
    if config.arch == "deepfm":
        specs["deep"] = mlp(len(config.mlp_dims) + 1)
    if config.arch == "dcn_v2":
        specs["cross_w"] = (None, None, None)
        specs["cross_b"] = (None, None)
        specs["deep"] = mlp(len(config.mlp_dims) + 1)
    if config.arch == "dlrm":
        specs["bot"] = mlp(len(config.bot_mlp))
        specs["top"] = mlp(len(config.top_mlp))
    return specs


def _field_offsets(config: RecsysConfig, device) -> torch.Tensor:
    return (torch.arange(config.n_sparse, dtype=torch.int32, device=device)
            * config.vocab_per_field)


def _sparse_ids(params: Dict, batch: Dict,
                config: RecsysConfig) -> torch.Tensor:
    """The batch's per-field ids as rows of the one logical table:
    ``[B, F]`` int32 on the parameters' device."""
    dev = params["embed"].device
    sparse = torch.as_tensor(batch["sparse"], dtype=torch.int32, device=dev)
    return (sparse + _field_offsets(config, dev)[None, :]).contiguous()


def _dense(params: Dict, batch: Dict) -> torch.Tensor:
    return torch.as_tensor(batch["dense"], dtype=torch.float32,
                           device=params["embed"].device)


def _gather_fields(params: Dict, batch: Dict, config: RecsysConfig):
    """The batch's table rows ``ids [B, F]`` and their embeddings
    ``[B, F, d]``."""
    ids = _sparse_ids(params, batch, config)
    return ids, embedding_lookup(params["embed"], ids)


# ---------------------------------------------------------------------------
# Interactions (``fm_interaction`` is kernel B6's entry point, imported)
# ---------------------------------------------------------------------------


def dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise dots. vectors: ``[B, n, d]`` -> ``[B, n(n-1)/2]``,
    pairs in ``jnp.triu_indices``' row-major order."""
    n = vectors.shape[1]
    gram = torch.einsum("bnd,bmd->bnm", vectors, vectors)
    iu, ju = torch.triu_indices(n, n, offset=1, device=vectors.device)
    return gram[:, iu, ju]


def cross_layer(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """DCN-v2 full-matrix cross: x' = x0 * (W x + b) + x."""
    return x0 * (x @ w + b) + x


# ---------------------------------------------------------------------------
# Forward and loss per architecture
# ---------------------------------------------------------------------------


def forward(params: Dict, batch: Dict, config: RecsysConfig) -> torch.Tensor:
    """Returns logits ``[B]``."""
    ids, emb = _gather_fields(params, batch, config)              # [B, F, d]
    B = emb.shape[0]
    if config.arch in ("fm", "deepfm"):
        # first-order term: kernel B5 over the weights as a [V, 1] table
        first = embedding_bag(params["linear"][:, None], ids, "sum")[:, 0]
        fm = params["bias"] + first + fm_interaction(emb)
        if config.arch == "fm":
            return fm
        return fm + mlp_apply(params["deep"], emb.reshape(B, -1))[:, 0]
    if config.arch == "dcn_v2":
        x0 = torch.cat([_dense(params, batch), emb.reshape(B, -1)], dim=-1)
        x = x0
        for layer in range(config.n_cross_layers):
            x = cross_layer(x0, x, params["cross_w"][layer],
                            params["cross_b"][layer])
        return mlp_apply(params["deep"], x)[:, 0]
    if config.arch == "dlrm":
        bot = mlp_apply(params["bot"], _dense(params, batch), final_act=True)
        vectors = torch.cat([bot[:, None, :], emb], dim=1)
        z = torch.cat([bot, dot_interaction(vectors)], dim=-1)
        return mlp_apply(params["top"], z)[:, 0]
    raise ValueError(config.arch)


def loss_fn(params: Dict, batch: Dict,
            config: RecsysConfig) -> Tuple[torch.Tensor, Dict]:
    """Mean binary cross-entropy of :func:`forward`'s logits against
    ``batch["label"]`` (the stable form ``max(z, 0) - z y + log1p(exp(-|z|))``)
    and the accuracy of ``z > 0`` against ``y > 0.5``: ``(loss, {"bce",
    "acc"})``, 0-d float32 tensors."""
    logits = forward(params, batch, config)
    y = torch.as_tensor(batch["label"], device=logits.device).float()
    # jax's subgradients at a logit of exactly 0 (a ReLU tower's output
    # can be): max splits the tie (0.5), |z| takes +1
    absz = torch.where(logits >= 0, logits, -logits)
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-absz)))
    acc = torch.mean(((logits > 0) == (y > 0.5)).float())
    return loss, {"bce": loss, "acc": acc}


# ---------------------------------------------------------------------------
# Retrieval head (the paper's technique in-system)
# ---------------------------------------------------------------------------


def query_tower(params: Dict, batch: Dict,
                config: RecsysConfig) -> torch.Tensor:
    """User/query embedding u(x) for SEP-LR retrieval, ``[B, d]``: the
    field mean, kernel B5 in mean mode."""
    u = embedding_bag(params["embed"], _sparse_ids(params, batch, config),
                      "mean")
    if config.arch == "dlrm" and config.n_dense:
        return mlp_apply(params["bot"], _dense(params, batch),
                         final_act=True) + u
    return u


def retrieval_scores(params: Dict, batch: Dict, candidates,
                     config: RecsysConfig) -> torch.Tensor:
    """Naive scoring of all candidates: ``[B, n_candidates]``. The exact
    top-K path goes through :mod:`repro_torch.serving` instead."""
    u = query_tower(params, batch, config)
    cand = torch.as_tensor(candidates, dtype=torch.float32, device=u.device)
    return torch.einsum("bd,md->bm", u, cand)
