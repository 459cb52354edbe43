"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps --batch --seq-len --lr --ckpt-dir --ckpt-every --seed --device]``.

It trains the arch's smoke configuration end to end on ``--device``
(default ``cuda``) with the whole substrate: the seeded synthetic data
through :class:`repro_torch.data.loader.PrefetchLoader`, AdamW (warmup
10 steps, cosine to ``--steps``), fault-tolerant checkpoints and resume.
Every family trains: the LMs (``gemma-2b``, ``olmoe-1b-7b`` and the
other ``lm`` archs: :func:`repro_torch.models.transformer.loss_fn` over
``lm_batches`` of ``--batch`` sequences of ``--seq-len`` tokens), the GNN
(``pna``: :func:`repro_torch.models.gnn.loss_fn` over a fresh
``random_graph`` of 256 nodes and 1,024 edges a step, from ``--seed``;
``--batch`` and ``--seq-len`` unread) and the recsys family (``fm``,
``deepfm``, ``dcn-v2``, ``dlrm-rm2``; ``--seq-len`` unread).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import (lm_batches, random_graph,
                                        recsys_batches)
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

MODELS = {"lm": tf_mod, "gnn": gnn_mod, "recsys": recsys_mod}


def build(arch_id: str, batch: int, seq_len: int, seed: int, device=None):
    """``(config, params, loss, make_data)`` of ``arch_id``'s smoke config,
    the parameters drawn from ``seed`` on ``device`` (``None`` = ``cuda``)."""
    spec = get_arch(arch_id)
    family = spec.family
    dev = resolve_device(device)
    cfg = spec.make_smoke_config()
    mod = MODELS[family]
    params = mod.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)

    def loss(p, b):
        return mod.loss_fn(p, b, cfg)

    def graphs():
        rng = np.random.default_rng(seed)
        while True:
            yield random_graph(rng, 256, 1024, cfg.d_in, cfg.n_classes)

    def data():
        if family == "lm":
            return lm_batches(seed, cfg.vocab_size, batch, seq_len)
        if family == "gnn":
            return graphs()
        return recsys_batches(seed, cfg.n_dense, cfg.n_sparse,
                              cfg.vocab_per_field, batch)

    return cfg, params, loss, data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)

    cfg, params, loss, data = build(args.arch, args.batch, args.seq_len,
                                    args.seed, args.device)
    opt = OptimizerConfig(kind="adamw", lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    tr = Trainer(loss, params, opt, PrefetchLoader(data),
                 TrainerConfig(total_steps=args.steps, log_every=10,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir))
    final = tr.run()
    first = tr.history[0]["loss"] if tr.history else float("nan")
    print(f"arch={args.arch} config={cfg.name} steps={tr.step} "
          f"loss {first:.4f} -> {final.get('loss', float('nan')):.4f}")
    return tr


if __name__ == "__main__":
    main()
