"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
dense LM for a few hundred steps on synthetic data with the full substrate
(AdamW, checkpointing, the fault-tolerant trainer), then decode a few
tokens through the exact top-K vocab head (the SEP-LR head).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--tiny]
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu

``--tiny`` shrinks the model to 2 layers of width 128 (a CI-sized run);
the default ~100M config is the "train a real model" path. The loss is
``models/transformer.py: loss_fn``: per-layer remat and the chunked
cross-entropy, bf16 compute over fp32 weights. Checkpoints go to a fresh
temporary directory unless ``--ckpt-dir`` names one (a run resumes from
the latest checkpoint it finds there).
"""

import argparse
import tempfile

import torch

from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import transformer as tf_mod
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    if args.tiny:
        cfg = tf_mod.TransformerConfig(
            name="lm-tiny", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=2048,
            logit_chunk=64, kv_block=64)
    else:
        # ~100M params: 12L x 768d (GPT-2-small-ish), GQA 12/4
        cfg = tf_mod.TransformerConfig(
            name="lm-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32768,
            logit_chunk=128, kv_block=128)
    params = tf_mod.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params, "
          f"on {dev}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix=f"ckpt_{cfg.name}_")
    opt = OptimizerConfig(kind="adamw", lr=3e-3 if args.tiny else 6e-4,
                          warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    data = PrefetchLoader(lambda: lm_batches(
        0, cfg.vocab_size, args.batch, args.seq_len))
    tr = Trainer(lambda p, b: tf_mod.loss_fn(p, b, cfg), params, opt, data,
                 TrainerConfig(total_steps=args.steps, log_every=10,
                               ckpt_every=max(args.steps // 4, 10),
                               ckpt_dir=ckpt_dir))
    final = tr.run()
    data.close()
    print(f"trained {tr.step} steps; loss "
          f"{tr.history[0]['loss']:.4f} -> {final['loss']:.4f}; "
          f"checkpoints in {ckpt_dir}")

    # --- decode through the exact top-K head (the paper's technique) -----
    cache = tf_mod.init_kv_cache(cfg, 1, 32, device=dev)
    tok = torch.tensor([[1]], dtype=torch.int32, device=dev)
    with torch.no_grad():
        for t in range(8):
            (vals, idx), cache = tf_mod.serve_step(tr.params, cache, tok, t,
                                                   cfg, top_k=8)
            tok = idx[:, :1]   # greedy decode from the exact top-K set
    print("decoded 8 tokens via the SEP-LR top-K head; last top-8 ids:",
          idx[0].tolist())


if __name__ == "__main__":
    main()
