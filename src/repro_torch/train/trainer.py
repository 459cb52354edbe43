"""Fault-tolerant training loop.

Responsibilities, as the reference's:
* builds the train step (gradients of every parameter leaf, then
  :func:`repro_torch.train.optimizer.apply_updates`);
* resumes from the latest valid checkpoint (params + optimizer + step);
* fast-forwards the data stream so restarts are bitwise deterministic;
* periodic asynchronous checkpoints; a final blocking one;
* the simulated-preemption hook (``fail_at_step``) of the restart tests;
* the straggler count: per-step wall time is recorded, and steps slower
  than ``straggler_factor`` x the median so far are counted in the
  metrics.

The reference jits its step and donates the parameter and optimizer
buffers. PyTorch runs eagerly, so there is no jit here; in place of the
donation, ``apply_updates`` writes the parameters and moments in place.
A step on the card is bitwise repeatable: the recsys kernels' gradients
scatter deterministically (:func:`repro_torch.kernels.embedding_bag.row_grad`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_state)
from repro_torch.train.tree import tree_leaves, tree_unflatten

PyTree = Any


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    fail_at_step: int = -1          # simulate preemption (tests)
    straggler_factor: float = 3.0


class SimulatedPreemption(RuntimeError):
    pass


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``loss, metrics = loss_fn(params, batch)``, the gradient
    of every parameter leaf (zeros for a leaf the loss does not read),
    then one optimizer step in place. ``metrics`` holds ``loss``, the
    loss function's metrics, ``lr`` and ``grad_norm`` as 0-d tensors."""

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state, opt_m = apply_updates(
            opt_cfg, params, tree_unflatten(params, grads), opt_state)
        out = {"loss": loss, **metrics, **opt_m}
        return params, opt_state, {k: v.detach() for k, v in out.items()}

    return train_step


def _to(node, dev: torch.device):
    if isinstance(node, dict):
        return {key: _to(v, dev) for key, v in node.items()}
    if isinstance(node, np.ndarray):
        return torch.from_numpy(node).to(dev)
    if isinstance(node, torch.Tensor):
        return node.to(dev)
    return node


class Trainer:
    def __init__(self, loss_fn: Callable, params: PyTree,
                 opt_cfg: OptimizerConfig, data: Iterator[Dict],
                 cfg: TrainerConfig, to_device: Optional[Callable] = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data = data
        dev = tree_leaves(params)[0].device
        self.to_device = to_device or (lambda b: _to(b, dev))
        self.train_step = make_train_step(loss_fn, opt_cfg)
        self.params = params
        self.opt_state = init_state(opt_cfg, params)
        self.step = 0
        self.history: list = []
        self.manager = (CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
                        if cfg.ckpt_dir else None)

    # -- checkpoint glue -------------------------------------------------------

    def try_resume(self) -> bool:
        if self.manager is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        restored, step = self.manager.restore(state)
        if restored is None:
            return False
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(step)
        return True

    def save(self, block: bool = False):
        if self.manager is None:
            return
        self.manager.save(self.step,
                          {"params": self.params, "opt": self.opt_state},
                          extra={"history_len": len(self.history)},
                          block=block)

    # -- main loop ---------------------------------------------------------------

    def run(self) -> Dict[str, float]:
        resumed = self.try_resume()
        if hasattr(self.data, "skip") and resumed:
            self.data.skip(self.step)
        it = iter(self.data)
        step_times: list = []
        stragglers = 0
        last = None
        while self.step < self.cfg.total_steps:
            batch = self.to_device(next(it))
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])  # blocks; acts as the step barrier
            dt = time.perf_counter() - t0
            step_times.append(dt)
            med = float(np.median(step_times))
            if len(step_times) > 5 and dt > self.cfg.straggler_factor * med:
                stragglers += 1
            self.step += 1
            last = {k: float(v) for k, v in metrics.items()}
            last.update(step=self.step, step_time=dt, stragglers=stragglers)
            if self.step % self.cfg.log_every == 0 or self.step == 1:
                self.history.append(last)
            if self.manager and self.step % self.cfg.ckpt_every == 0:
                self.save()
            if self.step == self.cfg.fail_at_step:
                # the checkpoint state is whatever the last periodic save
                # wrote: the crash semantics the restart test checks
                raise SimulatedPreemption(f"simulated failure @ {self.step}")
        self.save(block=True)
        return last or {}
