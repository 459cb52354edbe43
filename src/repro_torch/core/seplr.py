"""SEP-LR model container and adapters.

A separable linear relational model (paper Eq. 1) scores a (query, target)
couple as ``s(x, y) = u(x)^T t(y)``. The target side is a catalogue of M
items held as a dense ``[M, R]`` factor matrix on ``device``; the query
side is an R-vector or a ``[B, R]`` batch. Every model family of the
paper's Section 3 reduces to this container (see the ``from_*``
adapters).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class SepLRModel:
    """A trained SEP-LR model over a finite catalogue.

    Attributes:
      targets: ``[M, R]`` float32 target factors t(y), one row per item,
        moved to ``device`` (``None`` = ``cuda``) on construction.
      name: human-readable tag used in benchmark output.
    """

    targets: torch.Tensor
    name: str = "seplr"
    device: dataclasses.InitVar[Optional[str]] = None

    def __post_init__(self, device):
        t = torch.as_tensor(self.targets, dtype=torch.float32,
                            device=resolve_device(device)).contiguous()
        object.__setattr__(self, "targets", t)

    @property
    def num_targets(self) -> int:
        return int(self.targets.shape[0])

    @property
    def rank(self) -> int:
        return int(self.targets.shape[1])

    def score_all(self, u: torch.Tensor) -> torch.Tensor:
        """Naive scoring of every target: ``[R] -> [M]`` or ``[B,R] -> [B,M]``."""
        return u @ self.targets.T

    def score(self, u: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Score a subset of targets. ``u: [R]``, ``ids: [n]`` -> ``[n]``."""
        return self.targets[ids] @ u


# ---------------------------------------------------------------------------
# Adapters (paper Section 3)
# ---------------------------------------------------------------------------


def from_cosine_similarity(item_matrix, name: str = "memory_cf",
                           device=None) -> SepLRModel:
    """Memory-based CF: unit-norm rows make the dot product the cosine
    similarity (paper Eq. 5/6). Queries go through :func:`normalize_query`.
    """
    x = torch.as_tensor(item_matrix, dtype=torch.float32,
                        device=resolve_device(device))
    norms = torch.linalg.norm(x, dim=1, keepdim=True)
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    return SepLRModel(x / norms, name=name, device=x.device)


def normalize_query(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def from_matrix_factorization(item_factors, name: str = "mf",
                              device=None) -> SepLRModel:
    """Model-based CF: ``C ~= U T``; queries are rows of U."""
    return SepLRModel(item_factors, name=name, device=device)


def from_linear_multilabel(label_weights, name: str = "multilabel",
                           device=None) -> SepLRModel:
    """Binary-relevance linear models: ``s(x, y) = w_y^T psi(x)``;
    ``label_weights`` is ``[M_labels, R_features]``."""
    return SepLRModel(label_weights, name=name, device=device)


def from_pairwise_kronecker(W, phi_targets, name: str = "kronecker",
                            device=None) -> SepLRModel:
    """Pairwise model ``s(x,y) = psi(x)^T W phi(y)``: ``W`` folds into the
    query side (:func:`kronecker_query`), ``t(y) = phi(y)``."""
    del W  # folded at query time
    return SepLRModel(phi_targets, name=name, device=device)


def kronecker_query(W: torch.Tensor, psi_x: torch.Tensor) -> torch.Tensor:
    return psi_x @ W


# ---------------------------------------------------------------------------
# Synthetic model generator used by tests, the CLI and chip_smoke.py
# ---------------------------------------------------------------------------


def random_model(
    rng: np.random.Generator,
    num_targets: int,
    rank: int,
    distribution: str = "normal",
    sparsity: float = 0.0,
    name: Optional[str] = None,
    device=None,
) -> SepLRModel:
    """Random SEP-LR model with controllable factor distribution.

    Draws with numpy's ``Generator`` exactly as the reference does, so one
    seed gives the same catalogue in both packages. ``distribution``:
    ``normal`` (iid N(0, 1)), ``lognormal`` (heavy-tailed positive
    factors) or ``lowrank_spectrum`` (factors scaled by a decaying
    ``1/sqrt(1+r)`` spectrum).
    """
    T = rng.standard_normal((num_targets, rank)).astype(np.float32)
    if distribution == "lognormal":
        T = np.abs(rng.lognormal(0.0, 1.0, (num_targets, rank))).astype(np.float32)
    elif distribution == "lowrank_spectrum":
        spectrum = (1.0 / np.sqrt(1.0 + np.arange(rank))).astype(np.float32)
        T = T * spectrum[None, :]
    if sparsity > 0.0:
        mask = rng.random((num_targets, rank)) >= sparsity
        T = T * mask
    return SepLRModel(
        targets=torch.from_numpy(np.ascontiguousarray(T, np.float32)),
        name=name or f"random_{distribution}_M{num_targets}_R{rank}",
        device=device,
    )
