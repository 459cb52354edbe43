"""Architecture registry types: each architecture is a selectable config.

An ArchSpec pairs the exact published configuration with its input-shape
set, plus a reduced smoke configuration exercised by the CPU tests. Only
the recsys family is ported so far; the LM and GNN shape sets come with
their models.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) cell."""
    name: str
    kind: str                  # recsys_train | recsys_serve | recsys_retrieval
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                        # recsys
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


RECSYS_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
    ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "recsys_retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)
