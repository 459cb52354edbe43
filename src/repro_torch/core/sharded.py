"""The mesh-free two-level merge of shard-major score blocks.

The reference's ``core/sharded.py`` holds its distributed strategies
(``shard_map`` over a device mesh, ROADMAP A5) and
:func:`shard_fold_topk`, the host-loop merge the LSM catalogue's L1 tier
folds through (DESIGN.md §15). Only the latter is ported here: it needs no
mesh, and it is plain PyTorch, as the reference computes it outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.driver import merge_block_into_carry_batched


def shard_fold_topk(carry_vals: torch.Tensor, carry_ids: torch.Tensor,
                    scores: torch.Tensor, gids: torch.Tensor, k: int):
    """Fold ``S`` shard blocks into every query's ``[B, K]`` carry, one
    shard at a time, in shard order.

    ``scores [S, B, C]`` are one dense block per shard over the SAME query
    batch; ``gids [S, C]`` (or per-lane ``[S, B, C]``) carry global ids
    with ``-1`` marking dead or padding lanes (already ``-inf`` in
    ``scores``). Level 1 cuts each shard's block to ``K`` candidates (the
    block-local top-k of
    :func:`repro_torch.core.driver.merge_block_into_carry_batched`); level
    2 folds them through the O(K) sorted merge, the carry winning ties.
    Exact: the global top-K lies in the union of the per-shard top-Ks.
    """
    for s in range(scores.shape[0]):
        carry_vals, carry_ids = merge_block_into_carry_batched(
            carry_vals, carry_ids, scores[s], gids[s], k)
    return carry_vals, carry_ids
