"""Partial Threshold Algorithm (paper Algorithm 3 + Eq. 4), item at a
time in numpy.

A copy of the reference's host oracle. It walks TA's item set; within
one item's score the accumulation starts from the round's upper bound and
swaps in true contributions dimension by dimension, aborting as soon as
the partially corrected score can no longer beat the lower bound:

    s~ = upperBound(d);  for l = 1..R:  s~ += u_l t_l(y) - u_l t_l(y_{L_l(d)})
    abort when s~ < lowerBound

The oracle records the fraction of a score computed per item (the
paper's Fig. 2 metric). The ``partial`` registry engine runs it per
query.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.core.threshold import _query_order_np

NEG_INF = float("-inf")


class PartialTAStats(NamedTuple):
    n_items_touched: int       # == TA's n_scored (same item set, Thm 4 logic)
    n_full_scores: int         # items whose score was fully evaluated
    avg_score_fraction: float  # mean fraction of the R terms evaluated
    total_mults: int           # total multiply-adds spent on scoring
    depth: int


def partial_threshold_topk_np(
    T: np.ndarray,
    order_desc: np.ndarray,
    u: np.ndarray,
    k: int,
) -> Tuple[np.ndarray, np.ndarray, PartialTAStats]:
    M, R = T.shape
    k = min(k, M)
    order = _query_order_np(order_desc, u)
    active = np.nonzero(u)[0]   # sparse queries: same walk as TA

    calculated = np.zeros(M, dtype=bool)
    top_vals = np.full(k, NEG_INF)
    top_ids = np.full(k, -1, dtype=np.int64)
    n_items = 0
    n_full = 0
    total_terms = 0
    lower, upper = NEG_INF, np.inf

    d = 0
    while lower < upper and d < M:
        heads = order[:, d]                       # y_{L_r(d)} for each r
        head_terms = u * T[heads, np.arange(R)]   # u_r * t_r(y_{L_r(d)})
        upper = float(head_terms.sum())
        for r in active:
            y = order[r, d]
            if calculated[y]:
                continue
            calculated[y] = True
            n_items += 1
            # Algorithm 3: start from the upper bound, swap in true terms.
            s_tilde = upper
            completed = True
            terms = 0
            for l in range(R):
                s_tilde += u[l] * T[y, l] - head_terms[l]
                terms += 1
                if s_tilde < lower:
                    completed = False
                    break
            total_terms += terms
            if completed:
                n_full += 1
                score = s_tilde  # == full score after all R corrections
                if score > top_vals[-1]:
                    pos = np.searchsorted(-top_vals, -score)
                    top_vals = np.insert(top_vals, pos, score)[:k]
                    top_ids = np.insert(top_ids, pos, y)[:k]
        lower = top_vals[-1]
        d += 1

    stats = PartialTAStats(
        n_items_touched=n_items,
        n_full_scores=n_full,
        avg_score_fraction=(total_terms / (n_items * R)) if n_items else 0.0,
        total_mults=total_terms,
        depth=d,
    )
    return top_vals, top_ids, stats
