"""Quickstart of the PyTorch/CUDA port: build a SEP-LR model, index it,
and query exact top-K through three engines (the paper's core loop).

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card the Threshold Algorithm's and the Block Threshold Algorithm's
list scans score their candidates past the list prefix with the CUDA
kernel ``gather_scores``; on the CPU with its plain PyTorch version.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    blocked_topk,
    build_index,
    naive_topk,
    random_model,
    threshold_topk_from_index,
)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu runs the kernels' "
                     "plain versions)")
device = torch.device(ap.parse_args().device)

# 1) A trained SEP-LR model is just a catalogue of target factors t(y).
#    (Any matrix-factorisation / multi-label / dyadic model reduces to this
#    — see repro_torch.core.seplr adapters.)
rng = np.random.default_rng(0)
model = random_model(rng, num_targets=50_000, rank=30,
                     distribution="lowrank_spectrum", device=device)
print(f"catalogue: M={model.num_targets} items, R={model.rank}, "
      f"on {device}")

# 2) Build the sorted-list index once, offline (O(R M log M)).
index = build_index(model.targets, device=device)

# 3) Query. The naive baseline scores all M items...
u = torch.from_numpy((rng.standard_normal(model.rank).astype(np.float32)
                      * (1.0 / np.sqrt(1.0 + np.arange(model.rank))))
                     .astype(np.float32)).to(device)
naive = naive_topk(model.targets, u, k=10)
print(f"naive     : top-1 score {float(naive.values[0]):.4f}, "
      f"{int(naive.n_scored):>6d} scores computed")

# ...the Threshold Algorithm proves the same top-10 after far fewer scores...
ta = threshold_topk_from_index(model.targets, index, u, k=10)
print(f"TA        : top-1 score {float(ta.values[0]):.4f}, "
      f"{int(ta.n_scored):>6d} scores computed "
      f"({int(ta.n_scored) / model.num_targets:.1%} of naive), "
      f"depth {int(ta.depth)} rounds")

# ...and the Block Threshold Algorithm does it in block-shaped work.
bta = blocked_topk(model.targets, index.order_desc, index.t_sorted_desc,
                   u, k=10, block_size=256)
print(f"BTA(b=256): top-1 score {float(bta.values[0]):.4f}, "
      f"{int(bta.n_scored):>6d} scores computed, "
      f"{int(bta.depth) // 256} blocks")

want = np.sort(naive.values.cpu().numpy())
for name, res in (("TA", ta), ("BTA", bta)):
    got = np.sort(res.values.cpu().numpy())
    if not np.allclose(want, got, rtol=1e-5, atol=1e-4):
        raise SystemExit(f"{name}'s top-10 differs from naive's")
print("all three engines returned the identical exact top-10.")
