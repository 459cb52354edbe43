"""Fagin's algorithm (paper Algorithm 1), item at a time in numpy.

A copy of the reference's host oracle. The paper drops it from its
experiments because its candidate buffer grows too fast in higher
dimensions (and Theorem 3 shows it is not instance-optimal). It is here
to reproduce Table 1's worked example and to check Theorem 4 (TA never
scores more items). The ``fagin`` registry engine runs it per query.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.core.threshold import _query_order_np


class FaginStats(NamedTuple):
    n_scored: int   # items scored in the sorted-access phase
    depth: int      # random-access depth at which K items were seen in all lists
    buffer_size: int  # peak |targetsToCheck| — the memory pathology


def fagin_topk_np(
    T: np.ndarray,
    order_desc: np.ndarray,
    u: np.ndarray,
    k: int,
) -> Tuple[np.ndarray, np.ndarray, FaginStats]:
    """Faithful Fagin. Returns (values[k], indices[k], stats)."""
    M, R = T.shape
    k = min(k, M)
    order = _query_order_np(order_desc, u)

    seen_count = np.zeros(M, dtype=np.int64)     # bookkeeping[y]
    targets_to_check: list[int] = []
    in_buffer = np.zeros(M, dtype=bool)
    n_in_all_lists = 0

    d = 0
    while n_in_all_lists < k and d < M:
        for r in range(R):
            y = order[r, d]
            if not in_buffer[y]:
                in_buffer[y] = True
                targets_to_check.append(y)
            seen_count[y] += 1
            if seen_count[y] == R:
                n_in_all_lists += 1
        d += 1

    ids = np.asarray(targets_to_check, dtype=np.int64)
    scores = T[ids] @ u
    top = np.argsort(-scores, kind="stable")[:k]
    stats = FaginStats(n_scored=len(ids), depth=d, buffer_size=len(ids))
    return scores[top], ids[top], stats
