"""Core of the port: model, index, layouts, scans and the engine registry.

The flat API mirrors the reference's ``repro.core``: every name of its
``__all__`` that the port has is re-exported here, from the port's own
modules, so ``from repro_torch.core import build_index`` works as
``from repro.core import build_index`` does. The reference's names the
port replaced (the single-query scan stack, by its batched drivers; the
jax ``shard_map`` shim, by :func:`repro_torch.core.mesh.shard_array`)
are listed in ``tests/test_torch_core_api.py``.
"""

from repro_torch.core.blocked import (
    blocked_topk,
    blocked_topk_batched,
    chunked_ta_topk,
    chunked_ta_topk_batched,
    norm_pruned_topk,
)
from repro_torch.core.driver import merge_topk_sorted
from repro_torch.core.engines import (
    CostTable,
    Engine,
    EngineContext,
    batch_bucket,
    engine_names,
    get_engine,
    list_engines,
    register_engine,
    select_engine,
)
from repro_torch.core.fagin import FaginStats, fagin_topk_np
from repro_torch.core.index import TopKIndex, build_index
from repro_torch.core.layout import (
    DEFAULT_PREFIX_DEPTH,
    ListMajorLayout,
    NormMajorLayout,
    RowMajorLayout,
    ShardedNormLayout,
    build_layout,
    layout_names,
)
from repro_torch.core.naive import (TopKResult, certificate_gaps,
                                    certified_counts, naive_topk)
from repro_torch.core.partial import PartialTAStats, partial_threshold_topk_np
from repro_torch.core import faults
from repro_torch.core.lsm import (DEFAULT_L1_CAPACITY_FACTOR,
                                  ShardedLsmCatalogue)
from repro_torch.core.segments import (
    DEFAULT_DELTA_CAPACITY,
    DeltaSegment,
    QueryInfo,
    SegmentedCatalogue,
    SegmentStats,
    Snapshot,
    delta_bucket,
)
from repro_torch.core.seplr import (
    SepLRModel,
    from_cosine_similarity,
    from_linear_multilabel,
    from_matrix_factorization,
    from_pairwise_kronecker,
    kronecker_query,
    normalize_query,
    random_model,
)
from repro_torch.core.sharded import (hierarchical_merge_topk,
                                      sharded_blocked_topk,
                                      sharded_naive_topk, sharded_norm_topk)
from repro_torch.core.strategies import rank_gather_first_keys
from repro_torch.core.threshold import (TAStats, threshold_topk,
                                       threshold_topk_from_index,
                                       threshold_topk_np)

__all__ = [
    "SepLRModel", "TopKIndex", "TopKResult", "TAStats", "build_index",
    "naive_topk", "threshold_topk", "threshold_topk_from_index",
    "threshold_topk_np", "blocked_topk", "blocked_topk_batched",
    "chunked_ta_topk", "chunked_ta_topk_batched", "norm_pruned_topk",
    "from_cosine_similarity",
    "from_matrix_factorization", "from_linear_multilabel",
    "from_pairwise_kronecker", "kronecker_query", "normalize_query",
    "random_model",
    # host oracles (paper Algorithms 1 and 3)
    "fagin_topk_np", "FaginStats", "partial_threshold_topk_np",
    "PartialTAStats",
    # engine layer
    "merge_topk_sorted", "rank_gather_first_keys",
    "Engine", "EngineContext", "register_engine", "get_engine",
    "CostTable", "list_engines", "engine_names", "batch_bucket",
    "select_engine",
    # sharded strategies (the mesh: repro_torch.core.mesh)
    "sharded_naive_topk", "sharded_blocked_topk", "sharded_norm_topk",
    "hierarchical_merge_topk",
    # layout subsystem
    "RowMajorLayout", "NormMajorLayout", "ListMajorLayout",
    "ShardedNormLayout", "build_layout", "layout_names",
    "DEFAULT_PREFIX_DEPTH",
    # robustness layer
    "certificate_gaps", "certified_counts",
    # streaming tier and the LSM ladder
    "SegmentedCatalogue", "Snapshot", "DeltaSegment", "QueryInfo",
    "SegmentStats", "delta_bucket", "DEFAULT_DELTA_CAPACITY", "faults",
    "ShardedLsmCatalogue", "DEFAULT_L1_CAPACITY_FACTOR",
]
