"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718]: 4
aggregators (mean, max, min, std) x 3 degree scalers (identity,
amplification, attenuation), the counterpart of the reference's
``models/gnn.py`` with the same names and parameter tree.

Graph batch layout (static shapes, padded; tensors, or numpy arrays that
are moved to the parameters' device):
  nodes:    [N, F] float
  edge_src: [E] int32     (messages flow src -> dst)
  edge_dst: [E] int32
  edge_mask:[E] bool      (padding)
  node_mask:[N] bool
  labels:   [N] int32 (node classification) or [G] (graph tasks)
  graph_ids:[N] int32     (for batched small graphs / readout)
  n_graphs: int           (optional; else ``max(graph_ids) + 1``)

Message passing is plain PyTorch, as the reference computes it with XLA
segment ops and matmuls outside any Pallas kernel; no kernel of the port
runs on this path. Every reduction is deterministic, so two backward
passes on the card are bitwise equal (``Trainer``'s resume contract):

* the gathers ``h[src]`` and ``h[dst]`` go through
  :func:`repro_torch.kernels.embedding_bag.take_rows`, whose backward is
  ``row_grad``'s sorted, segmented sum;
* the segment sums (the degrees, each layer's sum and sum of squares, the
  graph readout) go through
  :func:`repro_torch.kernels.embedding_bag.segment_sum` over
  ``edge_dst`` sorted once a forward (:func:`~repro_torch.kernels.
  embedding_bag.segments`); an id outside ``[0, N)`` is dropped, as
  ``jax.ops.segment_sum`` drops it;
* max and min are ``scatter_reduce(..., "amax", include_self=False)``
  over ``-inf``, ``segment_max``'s identity; a tie's gradient is split
  evenly among the tied messages, as jax splits it (ReLU messages tie at 0
  often). No ``index_add_`` or float ``scatter_add`` is used.

The sharding (edges over "dp" in the reference) is a layout constraint
that changes no value: ``rules`` is accepted and read by nothing. The
optional link-prediction head :func:`link_scores` is SEP-LR: exact top-K
neighbour retrieval goes through :mod:`repro_torch.core`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.embedding_bag import (Segments, segment_sum,
                                               segments, take_rows)
from repro_torch.models.common import MeshRules, dense_init

AGGREGATORS = ("mean", "max", "min", "std")
SCALERS = ("identity", "amplification", "attenuation")


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 7
    delta: float = 2.5          # mean log-degree of the training graphs
    task: str = "node"          # node | graph
    compute_dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        d = self.d_hidden
        c = self.d_in * d + d                      # encoder
        per_layer = (2 * d) * d + d                # message MLP
        per_layer += (len(AGGREGATORS) * len(SCALERS) * d) * d + d  # update
        c += self.n_layers * per_layer
        c += d * self.n_classes + self.n_classes   # decoder
        return c


def init_params(config: PNAConfig, generator: torch.Generator,
                device=None) -> Dict:
    """LeCun-normal weights drawn from ``generator`` (which must live on
    ``device``, ``None`` = ``cuda``), zero biases: the reference's tree,
    the layers stacked ``[L, ...]``."""
    dev = resolve_device(device)
    d, L = config.d_hidden, config.n_layers
    n_cat = len(AGGREGATORS) * len(SCALERS) * d

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "enc_w": dense_init(generator, (config.d_in, d), dev),
        "enc_b": zeros(d),
        "layers": {
            "msg_w": dense_init(generator, (L, 2 * d, d), dev),
            "msg_b": zeros(L, d),
            "upd_w": dense_init(generator, (L, n_cat, d), dev),
            "upd_b": zeros(L, d),
        },
        "dec_w": dense_init(generator, (d, config.n_classes), dev),
        "dec_b": zeros(config.n_classes),
    }


def param_specs(config: PNAConfig, rules: MeshRules,
                mode: str = "train") -> Dict:
    """Partition specs matching :func:`init_params`, one tuple a tensor:
    every parameter replicated, as the reference's are."""
    rep2, rep1, rep3 = (None, None), (None,), (None, None, None)
    return {
        "enc_w": rep2, "enc_b": rep1,
        "layers": {"msg_w": rep3, "msg_b": rep2,
                   "upd_w": rep3, "upd_b": rep2},
        "dec_w": rep2, "dec_b": rep1,
    }


def _segment_max(x: torch.Tensor, segs: Segments) -> torch.Tensor:
    """``jax.ops.segment_max`` of ``x [E, d]``: ``-inf`` for an empty
    segment, a dropped id (``segs.ids == segs.num_segments``) lands in a
    sink row cut off at the end."""
    n = segs.num_segments
    out = x.new_full((n + 1, x.shape[1]), float("-inf"))
    out = out.scatter_reduce(0, segs.ids[:, None].expand_as(x), x, "amax",
                             include_self=False)
    return out[:n]


def _pna_aggregate(messages: torch.Tensor, segs: Segments,
                   edge_mask: torch.Tensor, degrees: torch.Tensor,
                   delta: float) -> torch.Tensor:
    """messages: ``[E, d]`` -> ``[N, 12d]`` (4 aggregators x 3 scalers).
    ``segs`` is :func:`segments` of ``edge_dst`` into the ``N`` nodes."""
    dt = messages.dtype
    w = edge_mask.to(dt)[:, None]
    m = messages * w
    seg_sum = segment_sum(m, segs)
    count = torch.clamp(degrees, min=1.0)[:, None].to(dt)
    mean = seg_sum / count
    big_neg = -1e30
    keep = edge_mask[:, None]
    mx = _segment_max(torch.where(keep, messages, big_neg), segs)
    mx = torch.where(mx <= big_neg / 2, 0.0, mx)
    mn = -_segment_max(torch.where(keep, -messages, big_neg), segs)
    mn = torch.where(mn >= -big_neg / 2, 0.0, mn)
    sq = segment_sum(m * m, segs)
    # jnp.maximum's gradient splits a tie (var exactly 0) in half, as
    # torch.maximum's does
    var = torch.maximum(sq / count - mean * mean, torch.zeros_like(mean))
    std = torch.sqrt(var + 1e-5)
    agg = torch.cat([mean, mx, mn, std], dim=-1)                 # [N, 4d]
    logd = torch.log1p(degrees)[:, None].to(dt)
    amp = logd / logd.new_full((), delta)   # true division on the card too
    att = delta / torch.clamp(logd, min=1e-5)
    return torch.cat([agg, agg * amp, agg * att], dim=-1)       # [N, 12d]


def _graph_tensors(graph: Dict, dev: torch.device):
    def t(key, dtype=None):
        return torch.as_tensor(graph[key], dtype=dtype, device=dev)
    return (t("nodes"), t("edge_src", torch.long), t("edge_dst", torch.long),
            t("edge_mask", torch.bool))


def forward(params: Dict, graph: Dict, config: PNAConfig,
            rules: MeshRules = MeshRules()) -> torch.Tensor:
    """Returns node logits ``[N, n_classes]`` (or graph logits ``[G,
    n_classes]`` for ``task="graph"``)."""
    dt = config.compute_dtype
    dev = params["enc_w"].device
    nodes, src, dst, emask = _graph_tensors(graph, dev)
    h = nodes.to(dt) @ params["enc_w"].to(dt) + params["enc_b"].to(dt)
    N = h.shape[0]
    segs = segments(dst, N)                 # sorted once, read every layer
    degrees = segs.sum(emask.float())
    lay = params["layers"]
    # unbound once a pass: one stacked gradient a leaf, not one a layer
    for mw, mb, uw, ub in zip(*(lay[k].unbind(0) for k in
                                ("msg_w", "msg_b", "upd_w", "upd_b"))):
        msg_in = torch.cat([take_rows(h, src), take_rows(h, dst)], dim=-1)
        m = F.relu(msg_in @ mw.to(dt) + mb.to(dt))
        agg = _pna_aggregate(m, segs, emask, degrees, config.delta)
        h = h + F.relu(agg @ uw.to(dt) + ub.to(dt))            # residual
    if config.task == "graph":
        gids = torch.as_tensor(graph["graph_ids"], dtype=torch.long,
                               device=dev)
        G = (int(graph["n_graphs"]) if "n_graphs" in graph
             else int(gids.max()) + 1)
        nmask = torch.as_tensor(graph["node_mask"], device=dev)
        pooled = segment_sum(h * nmask[:, None].to(dt), segments(gids, G))
        return pooled @ params["dec_w"].to(dt) + params["dec_b"].to(dt)
    return h @ params["dec_w"].to(dt) + params["dec_b"].to(dt)


def loss_fn(params: Dict, graph: Dict, config: PNAConfig,
            rules: MeshRules = MeshRules()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy of :func:`forward`'s logits against
    ``graph["labels"]`` over the masked nodes (every graph for
    ``task="graph"``) and the accuracy of their argmax: ``(xent, {"xent",
    "acc"})``, 0-d float32 tensors."""
    logits = forward(params, graph, config, rules).float()
    dev = logits.device
    labels = torch.as_tensor(graph["labels"], dtype=torch.long, device=dev)
    if config.task == "graph":
        mask = torch.ones(labels.shape, dtype=torch.float32, device=dev)
    else:
        mask = torch.as_tensor(graph["node_mask"], device=dev).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    xent = torch.sum((logz - gold) * mask) / denom
    pred = torch.argmax(logits, dim=-1)
    acc = torch.sum((pred == labels).float() * mask) / denom
    return xent, {"xent": xent, "acc": acc}


def link_scores(params: Dict, h: torch.Tensor,
                query_nodes: torch.Tensor) -> torch.Tensor:
    """SEP-LR link-prediction head: u = h[q], T = h — exact top-K
    neighbour retrieval goes through :mod:`repro_torch.core`."""
    return take_rows(h, query_nodes) @ h.T


# ---------------------------------------------------------------------------
# Neighbour sampler (host-side, numpy) — minibatch_lg cells; a copy of the
# reference's, so the same seed draws the same subgraph bit for bit
# ---------------------------------------------------------------------------


class NeighborSampler:
    """Uniform fanout sampler over a CSR adjacency (GraphSAGE-style)."""

    def __init__(self, edge_src: np.ndarray, edge_dst: np.ndarray,
                 num_nodes: int, seed: int = 0):
        order = np.argsort(edge_dst, kind="stable")
        self.src_sorted = edge_src[order].astype(np.int32)
        self.indptr = np.zeros(num_nodes + 1, np.int64)
        counts = np.bincount(edge_dst, minlength=num_nodes)
        self.indptr[1:] = np.cumsum(counts)
        self.num_nodes = num_nodes
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, fanouts=(15, 10)) -> Dict[str, np.ndarray]:
        """Returns a padded subgraph: layered sampling seeds<-hop1<-hop2."""
        nodes = [np.unique(seeds.astype(np.int32))]
        edges_src, edges_dst = [], []
        frontier = nodes[0]
        for f in fanouts:
            srcs, dsts = [], []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                nbrs = self.src_sorted[lo:hi]
                if len(nbrs) == 0:
                    continue
                take = nbrs if len(nbrs) <= f else self.rng.choice(nbrs, f, replace=False)
                srcs.append(take)
                dsts.append(np.full(len(take), v, np.int32))
            if srcs:
                srcs = np.concatenate(srcs)
                dsts = np.concatenate(dsts)
            else:
                srcs = np.zeros(0, np.int32)
                dsts = np.zeros(0, np.int32)
            edges_src.append(srcs)
            edges_dst.append(dsts)
            frontier = np.unique(srcs)
            nodes.append(frontier)
        all_nodes = np.unique(np.concatenate(nodes))
        remap = np.full(self.num_nodes, -1, np.int32)
        remap[all_nodes] = np.arange(len(all_nodes), dtype=np.int32)
        es = remap[np.concatenate(edges_src)] if edges_src else np.zeros(0, np.int32)
        ed = remap[np.concatenate(edges_dst)] if edges_dst else np.zeros(0, np.int32)
        return {
            "node_ids": all_nodes,
            "edge_src": es,
            "edge_dst": ed,
            "seed_local": remap[np.unique(seeds.astype(np.int32))],
        }


def pad_subgraph(sub: Dict[str, np.ndarray], feats: np.ndarray,
                 labels: np.ndarray, max_nodes: int, max_edges: int) -> Dict:
    """Pad a sampled subgraph to static shapes."""
    n = min(len(sub["node_ids"]), max_nodes)
    e = min(len(sub["edge_src"]), max_edges)
    nodes = np.zeros((max_nodes, feats.shape[1]), feats.dtype)
    nodes[:n] = feats[sub["node_ids"][:n]]
    lab = np.zeros((max_nodes,), np.int32)
    lab[:n] = labels[sub["node_ids"][:n]]
    node_mask = np.zeros((max_nodes,), bool)
    # supervise only the seed nodes
    seeds = sub["seed_local"][sub["seed_local"] < n]
    node_mask[seeds] = True
    es = np.zeros((max_edges,), np.int32)
    ed = np.zeros((max_edges,), np.int32)
    emask = np.zeros((max_edges,), bool)
    keep = (sub["edge_src"][:e] < n) & (sub["edge_dst"][:e] < n)
    es[:e] = np.where(keep, sub["edge_src"][:e], 0)
    ed[:e] = np.where(keep, sub["edge_dst"][:e], 0)
    emask[:e] = keep
    return {"nodes": nodes, "labels": lab, "node_mask": node_mask,
            "edge_src": es, "edge_dst": ed, "edge_mask": emask}
