"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps --batch --seq-len --lr --ckpt-dir --ckpt-every --seed --device]``.

It trains the arch's smoke configuration end to end on ``--device``
(default ``cuda``) with the whole substrate: the seeded synthetic data
through :class:`repro_torch.data.loader.PrefetchLoader`, AdamW (warmup
10 steps, cosine to ``--steps``), fault-tolerant checkpoints and resume.
The LMs (``gemma-2b``, ``olmoe-1b-7b`` and the other ``lm`` archs:
:func:`repro_torch.models.transformer.loss_fn` over ``lm_batches`` of
``--batch`` sequences of ``--seq-len`` tokens) and the recsys family
(``fm``, ``deepfm``, ``dcn-v2``, ``dlrm-rm2``; ``--seq-len`` unread)
train; the GNN's training is a later slice of the port and raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import lm_batches, recsys_batches
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# The reference's GNN arch, whose model is not in the port's registry yet
GNN_ARCHS = ("pna",)
LATER = {"gnn": "ROADMAP A7.6 (the GNN)"}


def build(arch_id: str, batch: int, seq_len: int, seed: int, device=None):
    """``(config, params, loss, make_data)`` of ``arch_id``'s smoke config,
    the parameters drawn from ``seed`` on ``device`` (``None`` = ``cuda``)."""
    family = "gnn" if arch_id in GNN_ARCHS else get_arch(arch_id).family
    if family in LATER:
        raise NotImplementedError(
            f"training the {family} family ({arch_id}) is not ported yet: "
            f"{LATER[family]}")
    dev = resolve_device(device)
    cfg = get_arch(arch_id).make_smoke_config()
    mod = tf_mod if family == "lm" else recsys_mod
    params = mod.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)

    def loss(p, b):
        return mod.loss_fn(p, b, cfg)

    def data():
        if family == "lm":
            return lm_batches(seed, cfg.vocab_size, batch, seq_len)
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
