"""gemma-2b training steps at full width and depth (8 x 1,024 tokens,
bf16 compute, remat on) with the ``[L, ...]`` layer stacks unbound once a
pass (``models/transformer.py: _layers``) against the same stacks indexed
``w[i]`` a layer, in turns (unbind, ``w[i]``, ``w[i]``, unbind) in one
process: every step's ms and each turn's peak memory.

Needs a CUDA device; run from the root of the repo:
``python3 scripts/lm_unbind_ab.py [--steps-per-turn 5]``.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_state)
from repro_torch.train.trainer import make_train_step  # noqa: E402


def indexed(params):
    """The stacks indexed ``w[i]`` a layer: each index's backward adds a
    zero tensor the size of the whole stack."""
    n = next(iter(params["layers"].values())).shape[0]
    return [{key: w[i] for key, w in params["layers"].items()}
            for i in range(n)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-per-turn", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    unbound = tf._layers
    cfg = get_arch("gemma-2b").make_config()
    dev = torch.device("cuda")
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = OptimizerConfig(kind="adamw", lr=3e-3, warmup_steps=10,
                          total_steps=8)
    state = init_state(opt, params)
    step = make_train_step(lambda p, b: tf.loss_fn(p, b, cfg), opt)
    stream = lm_batches(0, cfg.vocab_size, 8, 1024)
    batches = [{key: torch.from_numpy(v).to(dev) for key, v in b.items()}
               for _, b in zip(range(2), stream)]
    try:
        for label, layers in (("unbind", unbound), ("w[i]", indexed),
                              ("w[i]", indexed), ("unbind", unbound)):
            tf._layers = layers
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i in range(args.steps_per_turn):
                t = time.perf_counter()
                params, state, m = step(params, state,
                                        batches[i % len(batches)])
                float(m["loss"])
                times.append(1e3 * (time.perf_counter() - t))
            print(f"{label}: step ms {[round(x, 2) for x in times]}, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
    finally:
        tf._layers = unbound


if __name__ == "__main__":
    main()
