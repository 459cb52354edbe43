"""Synthetic recsys click logs, a numpy copy of the reference's
``data/synthetic.py: recsys_batches``: the same seed gives the same
batches in both packages.

Everything is deterministic in the seed: restarted jobs regenerate
bitwise-identical batches.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def recsys_batches(seed: int, n_dense: int, n_sparse: int, vocab_per_field: int,
                   batch: int) -> Iterator[Dict]:
    """Criteo-shaped synthetic clicks: power-law ids, planted logistic CTR.
    The reference's stream for shard 0 of 1 (sharded data comes with the
    sharding slice of the port)."""
    shard = 0
    ss = np.random.SeedSequence([seed, 7, shard])
    planted = np.random.default_rng(ss).standard_normal(
        (n_sparse, 8)).astype(np.float32)
    step = 0
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
        dense = rng.standard_normal((batch, n_dense)).astype(np.float32) \
            if n_dense else np.zeros((batch, 0), np.float32)
        sparse = (rng.zipf(1.3, (batch, n_sparse)) % vocab_per_field).astype(np.int32)
        # planted CTR signal so training can actually reduce the loss
        sig = np.tanh((sparse % 8) @ planted.sum(axis=1) / (4 * n_sparse))
        prob = 1.0 / (1.0 + np.exp(-2.0 * sig))
        label = (rng.random(batch) < prob).astype(np.float32)
        yield {"dense": dense, "sparse": sparse, "label": label}
        step += 1
