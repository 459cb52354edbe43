"""Synthetic corpora shaped like the paper's datasets, LM token streams,
recsys click logs and graphs: numpy copies of the reference's
``data/synthetic.py`` generators, so the same generator state gives
bitwise-identical arrays in both packages.

The paper's datasets (MovieLens, BookCrossing, Audioscrobbler, Uniprot,
LSHTC) cannot be downloaded here; these generators reproduce their shape
statistics (size, sparsity, implicit or explicit feedback, factor spectra,
popularity power laws), which is what the paper's efficiency claims
depend on.

Everything is deterministic in (seed, shard): restarted jobs regenerate
bitwise-identical batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Collaborative-filtering matrices (paper §4.1)
# ---------------------------------------------------------------------------


def cf_ratings(
    rng: np.random.Generator,
    n_users: int,
    n_items: int,
    density: float = 0.01,
    implicit: bool = False,
    rank: int = 20,
) -> np.ndarray:
    """Dense low-rank-plus-noise rating matrix with power-law item
    popularity: explicit feedback (ratings 1..5) or implicit (log play
    counts, non-negative)."""
    U = rng.standard_normal((n_users, rank)) / np.sqrt(rank)
    V = rng.standard_normal((n_items, rank)) / np.sqrt(rank)
    scores = U @ V.T
    popularity = rng.zipf(1.5, n_items).astype(np.float64)
    popularity = np.clip(popularity / popularity.max(), 1e-4, 1.0)
    mask = rng.random((n_users, n_items)) < density * popularity[None, :] \
        / popularity.mean()
    if implicit:
        M = np.where(mask, np.log1p(np.abs(scores) * 10), 0.0)
    else:
        M = np.where(mask, np.clip(np.round(3 + 2 * scores), 1, 5), 0.0)
    return M.astype(np.float32)


def probabilistic_pca(M: np.ndarray, rank: int, n_iters: int = 12,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """EM for probabilistic PCA (paper §4.1: Tipping & Bishop 1997), in
    the sigma^2 -> 0 limit (alternating least squares): returns
    ``(U [n, r], V [m, r])`` with ``M ~= U V^T``. Deterministic."""
    rng = np.random.default_rng(seed)
    n, m = M.shape
    W = rng.standard_normal((m, rank)).astype(np.float64) * 0.01
    X = M.astype(np.float64)
    for _ in range(n_iters):
        Z = X @ W @ np.linalg.inv(W.T @ W + 1e-6 * np.eye(rank))
        W = X.T @ Z @ np.linalg.inv(Z.T @ Z + 1e-6 * np.eye(rank))
    Z = X @ W @ np.linalg.inv(W.T @ W + 1e-6 * np.eye(rank))
    return Z.astype(np.float32), W.astype(np.float32)


# ---------------------------------------------------------------------------
# Multi-label ridge / PLS style factors (paper §4.2, §4.4)
# ---------------------------------------------------------------------------


def multilabel_factors(
    rng: np.random.Generator,
    n_labels: int,
    n_features: int,
    kind: str = "ridge",
) -> np.ndarray:
    """Label-side weight matrix ``T: [n_labels, R]``.

    ``ridge``: anisotropic weights with decaying feature relevance and a
    power-law label popularity (TA-friendly). ``pls``: orthogonalised,
    near-isotropic factors (the paper finds PLS TA-hostile: its variance
    is spread evenly).
    """
    T = rng.standard_normal((n_labels, n_features)).astype(np.float32)
    if kind == "ridge":
        spectrum = 1.0 / np.sqrt(1.0 + np.arange(n_features, dtype=np.float32))
        T *= spectrum[None, :]
        # label popularity skew (GO term frequencies are power-law)
        pop = rng.zipf(1.8, n_labels).astype(np.float32)
        T *= np.log1p(pop[:, None]) / 3.0
    elif kind == "pls":
        q, _ = np.linalg.qr(T.T @ T + 1e-3 * np.eye(n_features))
        T = (T @ q).astype(np.float32)
    return T


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------


def lm_batches(seed: int, vocab: int, batch: int, seq_len: int,
               shard: int = 0, num_shards: int = 1) -> Iterator[Dict]:
    """Zipf-distributed token stream; labels = next token. Infinite.
    Shard ``shard`` of ``num_shards`` gets ``batch // num_shards`` rows a
    step from its own stream."""
    local = batch // num_shards
    step = 0
    while True:
        # (seed, step, shard) -> independent, reproducible stream
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, shard]))
        toks = rng.zipf(1.2, (local, seq_len + 1)) % vocab
        toks = toks.astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step += 1


# ---------------------------------------------------------------------------
# Recsys click logs
# ---------------------------------------------------------------------------


def recsys_batches(seed: int, n_dense: int, n_sparse: int, vocab_per_field: int,
                   batch: int, shard: int = 0,
                   num_shards: int = 1) -> Iterator[Dict]:
    """Criteo-shaped synthetic clicks: power-law ids, planted logistic CTR.
    Shard ``shard`` of ``num_shards`` gets ``batch // num_shards`` rows a
    step from its own stream."""
    local = batch // num_shards
    ss = np.random.SeedSequence([seed, 7, shard])
    planted = np.random.default_rng(ss).standard_normal(
        (n_sparse, 8)).astype(np.float32)
    step = 0
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
        dense = rng.standard_normal((local, n_dense)).astype(np.float32) \
            if n_dense else np.zeros((local, 0), np.float32)
        sparse = (rng.zipf(1.3, (local, n_sparse)) % vocab_per_field).astype(np.int32)
        # planted CTR signal so training can actually reduce the loss
        sig = np.tanh((sparse % 8) @ planted.sum(axis=1) / (4 * n_sparse))
        prob = 1.0 / (1.0 + np.exp(-2.0 * sig))
        label = (rng.random(local) < prob).astype(np.float32)
        yield {"dense": dense, "sparse": sparse, "label": label}
        step += 1


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                 d_feat: int, n_classes: int = 7,
                 power_law: bool = True) -> Dict[str, np.ndarray]:
    """Power-law (preferential-attachment-ish) graph with planted community
    labels correlated with features (so GNN accuracy is learnable)."""
    if power_law:
        w = rng.zipf(1.6, n_nodes).astype(np.float64)
        p = w / w.sum()
        src = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
        dst = rng.choice(n_nodes, n_edges, p=p).astype(np.int32)
    else:
        src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
        dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + 0.5 * rng.standard_normal(
        (n_nodes, d_feat)).astype(np.float32)
    return {
        "nodes": feats,
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": np.ones(n_edges, bool),
        "node_mask": np.ones(n_nodes, bool),
        "labels": labels,
    }


def molecule_batch(rng: np.random.Generator, n_graphs: int, nodes_per: int,
                   edges_per: int, d_feat: int, n_classes: int = 2) -> Dict:
    """Batched small graphs flattened with offsets (molecule cells)."""
    N = n_graphs * nodes_per
    E = n_graphs * edges_per
    offs = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    src = (rng.integers(0, nodes_per, E) + offs).astype(np.int32)
    dst = (rng.integers(0, nodes_per, E) + offs).astype(np.int32)
    labels = rng.integers(0, n_classes, n_graphs).astype(np.int32)
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feats = (np.repeat(centers[labels], nodes_per, axis=0)
             + 0.7 * rng.standard_normal((N, d_feat))).astype(np.float32)
    return {
        "nodes": feats,
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": np.ones(E, bool),
        "node_mask": np.ones(N, bool),
        "labels": labels,
        "graph_ids": np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per),
        "n_graphs": n_graphs,
    }
