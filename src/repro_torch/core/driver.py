"""Top-K merge primitives of the pruned block scans.

Every exact scan keeps a running top-K (the carry, sorted descending) and
folds one block of candidate scores into it per step. The fold is two
stage: a block-local top-k over the bare block scores, then a sorted merge
of two descending lists of k entries — never a selection over ``K + C``
lanes. Tie order is the reference's: within a block the lower position
wins, and in the merge the CARRY wins (its ids come from earlier blocks).
Both follow from one stable descending sort. Masking and placement use
``torch.where``, never a multiplication: values can be ``-inf`` and
``-inf * 0`` is NaN.
"""

from __future__ import annotations

import torch

from repro_torch.core.naive import stable_topk

NEG_INF = float("-inf")


def merge_topk_sorted(a_vals: torch.Tensor, a_ids: torch.Tensor,
                      b_vals: torch.Tensor, b_ids: torch.Tensor, k: int):
    """Top-``k`` of two DESCENDING-sorted (vals, ids) lists along the last
    axis (batched over any leading axes). Ties rank the ``a`` side first.
    """
    cand_vals = torch.cat([a_vals, b_vals], dim=-1)
    cand_ids = torch.cat([a_ids, b_ids], dim=-1)
    top, pos = stable_topk(cand_vals, k)
    return top, torch.gather(cand_ids, -1, pos)


def pad_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Pad sorted (vals, ids) along the last axis to k slots of (-inf, -1)."""
    kk = vals.shape[-1]
    if kk >= k:
        return vals, ids
    lead = tuple(vals.shape[:-1])
    vals = torch.cat([vals, torch.full(lead + (k - kk,), NEG_INF,
                                       dtype=vals.dtype, device=vals.device)],
                     dim=-1)
    ids = torch.cat([ids, torch.full(lead + (k - kk,), -1, dtype=ids.dtype,
                                     device=ids.device)], dim=-1)
    return vals, ids


def _block_topk(masked_scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Block-local top-k (sorted descending), padded to k slots. ``ids``
    is shared along the leading axes (``[C]``) or matches the scores."""
    kk = min(k, masked_scores.shape[-1])
    vals, pos = stable_topk(masked_scores, kk)
    bids = ids[pos] if ids.dim() == 1 else torch.gather(ids, -1, pos)
    return pad_topk(vals, bids, k)


def merge_block_into_carry_batched(top_vals, top_ids, masked_scores,
                                   rows, k):
    """Fold one block of ``[B, C]`` masked scores into every query's
    ``[B, K]`` carry. ``rows`` is the block's id vector, SHARED across the
    batch (``[C]``) or per query (``[B, C]``)."""
    bv, bi = _block_topk(masked_scores, rows.to(top_ids.dtype), k)
    return merge_topk_sorted(top_vals, top_ids, bv, bi, k)
