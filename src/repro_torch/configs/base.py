"""Architecture registry types: each architecture is a selectable config.

An ArchSpec pairs the exact published configuration with its input-shape
set, plus a reduced smoke configuration exercised by the CPU tests: the
LMs, the GNN and the recsys family, each with its shape set.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) cell."""
    name: str
    kind: str                  # lm_train | lm_prefill | lm_decode |
    #                            gnn_train | recsys_train | recsys_serve |
    #                            recsys_retrieval
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                        # lm | gnn | recsys
    source: str                        # the published configuration
    make_config: Callable[..., object]     # full config
    make_smoke_config: Callable[..., object]
    shapes: Tuple[ShapeCell, ...]

    def shape(self, name: str) -> ShapeCell:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}; "
                       f"available: {[s.name for s in self.shapes]}")


LM_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "lm_train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "lm_prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "lm_decode", {"seq_len": 32768, "global_batch": 128}),
    # long_500k is a DECODE shape (1 token against a 512k KV cache):
    # linear in context, so full-attention archs run it.
    ShapeCell("long_500k", "lm_decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("full_graph_sm", "gnn_train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
               "n_classes": 7}),
    ShapeCell("minibatch_lg", "gnn_train",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout0": 15, "fanout1": 10, "d_feat": 602, "n_classes": 41,
               # padded subgraph sizes for the sampled-training step:
               # seeds + 15*seeds + 10*15*seeds nodes; edges 15s + 150s
               "pad_nodes": 1024 * (1 + 15 + 150), "pad_edges": 1024 * (15 + 150)}),
    ShapeCell("ogb_products", "gnn_train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_classes": 47}),
    ShapeCell("molecule", "gnn_train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 14,
               "n_classes": 2, "task": "graph"}),
)

RECSYS_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
    ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "recsys_retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)
