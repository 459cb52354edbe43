"""Optimizers written out from their formulas, as the reference's are:
AdamW, Adam, Adagrad and SGD with momentum, a linear-warmup cosine
schedule and global-norm clipping, over a tree of tensors
(:mod:`repro_torch.train.tree`).

The arithmetic is the reference's, term for term: ``b2`` defaults to
0.95; weight decay (AdamW) applies to leaves with ``ndim >= 2`` only; the
bias corrections are ``1 - b ** t`` with ``t`` the step in float32;
Adagrad and SGD keep a 0-d ``nu`` a leaf; the metrics are ``lr`` and the
gradient's global norm before clipping. ``torch.optim`` differs in these
details, so it is not used.

:func:`apply_updates` runs under ``torch.no_grad()`` and updates in place:
the parameters and both moments it is given are overwritten and
returned (the reference's jit donates those buffers to the same end), so
a caller that needs the old values copies them first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.train.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"            # adamw | adam | adagrad | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * lr``, in float32
    (a 0-d tensor on ``step``'s device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: PyTree           # first moment / momentum / accumulator
    nu: PyTree           # second moment (Adam), else a 0-d zero a leaf


def init_state(cfg: OptimizerConfig, params: PyTree) -> OptState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    step = torch.zeros((), dtype=torch.int32, device=dev)
    mu = tree_map(torch.zeros_like, params)
    if cfg.kind in ("adam", "adamw"):
        return OptState(step, mu, tree_map(torch.zeros_like, params))
    return OptState(step, mu, tree_map(
        lambda x: torch.zeros((), dtype=x.dtype, device=x.device), params))


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, summed leaf by
    leaf in flatten order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: PyTree,
                        max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm`` (new
    tensors), and the norm before scaling."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: PyTree, grads: PyTree,
                  state: OptState) -> Tuple[PyTree, OptState, Dict]:
    """One optimizer step, in place (see the module docstring). Returns
    ``(params, state, {"lr", "grad_norm"})``."""
    if cfg.grad_clip > 0:
        grads, raw_norm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        raw_norm = global_norm(grads)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    P, G = tree_leaves(params), tree_leaves(grads)
    M, N = tree_leaves(state.mu), tree_leaves(state.nu)

    if cfg.kind in ("adam", "adamw"):
        b1, b2 = cfg.b1, cfg.b2
        t = step.float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        for p, g, m, v in zip(P, G, M, N):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if cfg.kind == "adamw" and p.dim() >= 2:   # decay matrices only
                delta.add_(p, alpha=cfg.weight_decay)
            p.sub_(delta.mul_(lr))
    elif cfg.kind == "adagrad":
        for p, g, a in zip(P, G, M):
            a.addcmul_(g, g)
            p.sub_(lr * g / (torch.sqrt(a) + cfg.eps))
    elif cfg.kind == "sgd":
        for p, g, m in zip(P, G, M):
            m.mul_(cfg.momentum).add_(g)
            p.sub_(lr * m)
    else:
        raise ValueError(cfg.kind)
    return (params, OptState(step, state.mu, state.nu),
            {"lr": lr, "grad_norm": raw_norm})
