"""Dry-run cell builders: (architecture x input shape x mesh) -> a step
and its stand-ins.

Each builder returns a :class:`Cell`:
  fn            — the step callable (train step / prefill / serve_step /
                  retrieval);
  args          — meta-device stand-ins of the step's arguments (shapes
                  and dtypes, NO allocation: the counterpart of the
                  reference's ``jax.ShapeDtypeStruct``);
  in_shardings  — partition-spec trees matching ``args``, one tuple a
                  tensor, in the form :mod:`repro_torch.core.mesh` reads;
  model_flops   — the analytic "useful" FLOPs of the roofline
                  (6·N_active·D train / 2·N_active·D forward, + attention);
  meta          — the reference's record fields, plus, for a step that
                  reads less than all its parameters (a serving or
                  retrieval step), ``param_reads``: each parameter key it
                  reads -> the rows of the leading dimension it gathers
                  (one per id; ``None``: all of it). Keys left out are not
                  read. :func:`repro_torch.roofline.analysis.from_cell`
                  counts the bytes from it.

The mesh is passed explicitly; ``fn`` reads it where the port's step
takes one (the LM's expert-parallel MoE and vocab-sharded head, the
sharded retrieval). Building a cell never runs ``fn``: a GNN or recsys
step reads the host (its segment sort), which a meta tensor cannot give.
:func:`device_bytes` counts what one shard of the mesh holds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.core.sharded import sharded_naive_topk
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import MeshRules, cast_tree, spec_entry
from repro_torch.train.optimizer import OptimizerConfig, OptState, init_state
from repro_torch.train.trainer import make_train_step

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    model_flops: float
    meta: Dict[str, Any]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in _dp_axes(mesh))


def _dp_entry(mesh, batch: int):
    """The batch dimension's spec entry: the data axes where they divide
    it, else replicated."""
    dp = _dp_axes(mesh)
    return spec_entry(dp) if dp and batch % _dp_size(mesh) == 0 else None


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


OPT_CFG = OptimizerConfig(kind="adamw", lr=3e-4, total_steps=100_000,
                          warmup_steps=2000)


def _params_and_opt(init_fn):
    """Parameter and AdamW-state stand-ins from ``init_fn(generator,
    device)`` on the meta device."""
    params = init_fn(torch.Generator(), META)
    return params, init_state(OPT_CFG, params)


def _opt_spec(pspec) -> OptState:
    return OptState((), pspec, pspec)


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One shard's shape of an array of ``shape`` dealt by ``spec`` over
    ``mesh``: a split dimension takes ``ceil(dim / prod(axis sizes))``; a
    spec shorter than the shape replicates the dimensions after it."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        out.append(-(-n // math.prod(mesh.shape[a] for a in axes)))
    return tuple(out)


def _pairs(tree, spec):
    """``(tensor, spec)`` pairs of a stand-in tree and its spec tree."""
    if isinstance(tree, torch.Tensor):
        yield tree, spec
    elif isinstance(tree, dict):
        for key in tree:
            yield from _pairs(tree[key], spec[key])
    elif isinstance(tree, (list, tuple)):
        for x, s in zip(tree, spec, strict=True):
            yield from _pairs(x, s)


def device_bytes(tree, spec, mesh) -> int:
    """Bytes that one shard holds of the tensors of ``tree`` dealt by the
    matching ``spec`` tree over ``mesh``."""
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in _pairs(tree, spec))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_attn_flops(cfg, batch: int, seq: int, factor: float) -> float:
    # qk^T + pv per layer: 2 * 2 * B * H * S^2/2 (causal) * hd
    per_layer = 2.0 * batch * cfg.n_heads * seq * seq * cfg.head_dim
    return factor * cfg.n_layers * per_layer


def _build_lm(arch_id: str, cell: ShapeCell, mesh, rules: MeshRules,
              override: Optional[Dict] = None) -> Cell:
    spec = get_arch(arch_id)
    cfg = spec.make_config()
    if override:
        cfg = dataclasses.replace(cfg, **override)
    dims = cell.dims
    B, S = dims["global_batch"], dims["seq_len"]
    params, opt = _params_and_opt(
        lambda g, dev: tf_mod.init_params(cfg, g, dev))
    if cell.kind in ("lm_prefill", "lm_decode"):
        # serving weights are stored bf16, as the reference's cells store
        # them (halves the per-token weight read and the argument bytes)
        params = cast_tree(params, torch.bfloat16)

    if cell.kind == "lm_train":
        pspec = tf_mod.param_specs(cfg, rules, "train")
        batch = {"tokens": _sds((B, S), torch.int32),
                 "labels": _sds((B, S), torch.int32)}
        bspec = {"tokens": (spec_entry(_dp_axes(mesh)), None),
                 "labels": (spec_entry(_dp_axes(mesh)), None)}
        fn = make_train_step(
            lambda p, b: tf_mod.loss_fn(p, b, cfg, rules, mesh), OPT_CFG)
        args = (params, opt, batch)
        in_sh = (pspec, _opt_spec(pspec), bspec)
        out_sh = (pspec, _opt_spec(pspec), None)
        flops = 6.0 * cfg.active_param_count() * B * S \
            + 3.0 * _lm_attn_flops(cfg, B, S, 0.5)
    elif cell.kind == "lm_prefill":
        pspec = tf_mod.param_specs(cfg, rules, "serve")

        def fn(params, tokens):
            return tf_mod.prefill(params, tokens, cfg, rules, mesh=mesh)

        args = (params, _sds((B, S), torch.int32))
        in_sh = (pspec, (_dp_entry(mesh, B), None))
        out_sh = None
        flops = 2.0 * cfg.active_param_count() * B * S \
            + _lm_attn_flops(cfg, B, S, 0.5)
    elif cell.kind == "lm_decode":
        pspec = tf_mod.param_specs(cfg, rules, "serve")
        cache = tf_mod.init_kv_cache(cfg, B, S, device=META)
        cache_spec = tf_mod.kv_cache_specs(cfg, rules, B, S, mesh)

        def fn(params, cache, tokens, cache_len):
            return tf_mod.serve_step(params, cache, tokens, cache_len, cfg,
                                     rules, top_k=8, mesh=mesh)

        args = (params, cache, _sds((B, 1), torch.int32),
                _sds((), torch.int32))
        in_sh = (pspec, cache_spec, (_dp_entry(mesh, B), None), ())
        out_sh = None
        # one token per sequence + attention over the cache
        flops = 2.0 * cfg.active_param_count() * B \
            + 4.0 * cfg.n_layers * B * cfg.n_heads * S * cfg.head_dim
    else:
        raise ValueError(cell.kind)
    meta = {"config": cfg.name, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "batch": B, "seq": S}
    if cell.kind != "lm_train":
        # a serving step gathers the embedding at its tokens' rows only
        meta["param_reads"] = dict.fromkeys(params)
        meta["param_reads"]["embed"] = B * S if cell.kind == "lm_prefill" \
            else B
    return Cell(arch_id, cell.name, cell.kind, fn, args, in_sh, out_sh,
                flops, meta)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def gnn_model_flops(cfg, N: int, E: int) -> float:
    """FLOPs of one PNA training step over ``N`` nodes and ``E`` edges:
    the forward and the two products of the backward of each layer's
    message GEMM (``[E, 2d] x [2d, d]``) and update GEMM (``[N, 12d] x
    [12d, d]``), and of the encoder's (``[N, d_feat] x [d_feat, d]``)."""
    d = cfg.d_hidden
    return 3.0 * cfg.n_layers * (2.0 * E * (2 * d) * d
                                 + 2.0 * N * (12 * d) * d) \
        + 6.0 * N * cfg.d_in * d


def gnn_cell_dims(dims: Dict) -> Tuple[int, int]:
    """The cell's padded ``(nodes, edges)``: edges (and a sampled
    subgraph's nodes) padded to a multiple of 512."""
    if "pad_nodes" in dims:
        return _pad_to(dims["pad_nodes"], 512), _pad_to(dims["pad_edges"],
                                                         512)
    if dims.get("task") == "graph":
        return (dims["batch"] * dims["n_nodes"],
                _pad_to(dims["batch"] * dims["n_edges"], 512))
    return dims["n_nodes"], _pad_to(dims["n_edges"], 512)


def _build_gnn(arch_id: str, cell: ShapeCell, mesh, rules: MeshRules) -> Cell:
    spec = get_arch(arch_id)
    dims = cell.dims
    task = dims.get("task", "node")
    cfg = spec.make_config(d_feat=dims["d_feat"],
                           n_classes=dims["n_classes"], task=task)
    N, E = gnn_cell_dims(dims)

    graph = {
        "nodes": _sds((N, dims["d_feat"]), torch.float32),
        "edge_src": _sds((E,), torch.int32),
        "edge_dst": _sds((E,), torch.int32),
        "edge_mask": _sds((E,), torch.bool),
        "node_mask": _sds((N,), torch.bool),
        "labels": _sds((dims["batch"],) if task == "graph" else (N,),
                       torch.int32),
    }
    espec = (_dp_entry(mesh, E),)
    gspec = {"nodes": (None, None), "edge_src": espec, "edge_dst": espec,
             "edge_mask": espec, "node_mask": (None,), "labels": (None,)}
    static_ng = None
    if task == "graph":
        graph["graph_ids"] = _sds((N,), torch.int32)
        gspec["graph_ids"] = (None,)
        static_ng = dims["batch"]

    params, opt = _params_and_opt(
        lambda g, dev: gnn_mod.init_params(cfg, g, dev))
    pspec = gnn_mod.param_specs(cfg, rules)

    def loss(p, g):
        if static_ng is not None:
            g = dict(g, n_graphs=static_ng)
        return gnn_mod.loss_fn(p, g, cfg, rules)

    fn = make_train_step(loss, OPT_CFG)
    args = (params, opt, graph)
    in_sh = (pspec, _opt_spec(pspec), gspec)
    out_sh = (pspec, _opt_spec(pspec), None)
    return Cell(arch_id, cell.name, cell.kind, fn, args, in_sh, out_sh,
                gnn_model_flops(cfg, N, E),
                {"config": cfg.name, "params": cfg.param_count(),
                 "nodes": N, "edges": E})


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------


def _recsys_batch(cfg, B: int, mesh):
    batch = {"dense": _sds((B, cfg.n_dense), torch.float32),
             "sparse": _sds((B, cfg.n_sparse), torch.int32),
             "label": _sds((B,), torch.float32)}
    dp = _dp_entry(mesh, B)
    return batch, {"dense": (dp, None), "sparse": (dp, None),
                   "label": (dp,)}


def _recsys_mlp_flops(cfg) -> float:
    """per-example forward MACs x2 in the dense towers + interaction."""
    fl = 0.0
    if cfg.arch == "deepfm":
        dims = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims + (1,)
        fl += sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        fl += 4.0 * cfg.n_sparse * cfg.embed_dim
    if cfg.arch == "fm":
        fl += 4.0 * cfg.n_sparse * cfg.embed_dim
    if cfg.arch == "dcn_v2":
        d0 = cfg.interaction_input
        fl += cfg.n_cross_layers * 2.0 * d0 * d0
        dims = (d0,) + cfg.mlp_dims + (1,)
        fl += sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    if cfg.arch == "dlrm":
        dims = (cfg.n_dense,) + cfg.bot_mlp
        fl += sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        n = cfg.n_sparse + 1
        fl += 2.0 * n * n * cfg.embed_dim
        dims = (cfg.interaction_input,) + cfg.top_mlp
        fl += sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return fl


RETRIEVAL_K = 100
RETRIEVAL_PAD = 1 << 14   # candidates padded so every mesh splits them


def _build_recsys(arch_id: str, cell: ShapeCell, mesh,
                  rules: MeshRules) -> Cell:
    spec = get_arch(arch_id)
    cfg = spec.make_config()
    dims = cell.dims
    B = dims["batch"]
    params, opt = _params_and_opt(
        lambda g, dev: recsys_mod.init_params(cfg, g, dev))
    pspec = recsys_mod.param_specs(cfg, rules)
    batch, bspec = _recsys_batch(cfg, B, mesh)

    # a serving step gathers the tables (``embed`` and the first-order
    # ``linear``) at its ids' rows only
    n_ids = B * cfg.n_sparse
    reads = dict.fromkeys(params)
    reads.update({key: n_ids for key in ("embed", "linear") if key in params})
    if cell.kind == "recsys_train":
        reads = None
        fn = make_train_step(lambda p, b: recsys_mod.loss_fn(p, b, cfg),
                             OPT_CFG)
        args = (params, opt, batch)
        in_sh = (pspec, _opt_spec(pspec), bspec)
        out_sh = (pspec, _opt_spec(pspec), None)
        flops = 3.0 * B * _recsys_mlp_flops(cfg)
    elif cell.kind == "recsys_serve":
        def fn(p, b):
            return recsys_mod.forward(p, b, cfg)

        args = (params, batch)
        in_sh = (pspec, bspec)
        out_sh = None
        flops = 1.0 * B * _recsys_mlp_flops(cfg)
    elif cell.kind == "recsys_retrieval":
        M = _pad_to(dims["n_candidates"], RETRIEVAL_PAD)
        axes = tuple(a for a in ("data", "model") if a in mesh.shape)
        cand_spec = (spec_entry(axes), None)
        topk_fn = sharded_naive_topk(mesh, cand_spec, axes)
        batch.pop("label")
        bspec.pop("label")

        def fn(params, batch, candidates):
            u = recsys_mod.query_tower(params, batch, cfg)
            return topk_fn(candidates, u, RETRIEVAL_K)

        # the query tower reads the embedding (and DLRM's bottom MLP) only
        reads = {key: reads[key] for key in ("embed", "bot")
                 if key in params and (key == "embed" or cfg.n_dense)}

        # the candidate catalogue is served in bf16 (half the scan's
        # read); scores accumulate in fp32
        args = (params, batch, _sds((M, cfg.embed_dim), torch.bfloat16))
        in_sh = (pspec, bspec, cand_spec)
        out_sh = None
        flops = 2.0 * B * M * cfg.embed_dim
    else:
        raise ValueError(cell.kind)
    meta = {"config": cfg.name, "params": cfg.param_count(),
            "batch": dims.get("batch")}
    if reads is not None:
        meta["param_reads"] = reads
    return Cell(arch_id, cell.name, cell.kind, fn, args, in_sh, out_sh,
                flops, meta)


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, mesh,
               rules: Optional[MeshRules] = None,
               override: Optional[Dict] = None) -> Cell:
    """The cell of ``arch_id`` x ``shape_name`` on ``mesh`` (a
    :class:`repro_torch.core.mesh.Mesh`).

    ``override`` (LM only): ``dataclasses.replace`` kwargs on the config,
    e.g. a narrow, shallow model whose step the CPU can run.
    """
    rules = rules or MeshRules()
    spec = get_arch(arch_id)
    cell = spec.shape(shape_name)
    if spec.family == "lm":
        return _build_lm(arch_id, cell, mesh, rules, override)
    if spec.family == "gnn":
        return _build_gnn(arch_id, cell, mesh, rules)
    if spec.family == "recsys":
        return _build_recsys(arch_id, cell, mesh, rules)
    raise ValueError(spec.family)

