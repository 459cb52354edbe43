"""Kernel B1 (``topk_mips``) at the LSHTC-like shapes of its rows in
PERF.md §6, each held against its plain version and timed by
``chip_smoke.py``'s own ``compare_modes`` (cold L2, mean of 10, each phase
too) beside ``torch.topk(torch.matmul(U, T.T), k)``:

- B = 64, k = 10 in every mode (B1–B3's rows);
- B = 64, k = 522 in every mode (the streaming ladder's third rung);
- B = 8, k = 42, ``two_level_batched`` (the async tier's coalesced batch
  at the tombstoned first fetch; ``chip_smoke.py`` times it over the LSM
  ladder's snapshot, this script over the base catalogue), and B = 8 at
  k = 10 beside it (the register lists in place of the sort).

Each row also gives ``host_us``: the wrapper's host time per call, 20
calls queued back to back with no synchronisation between them.

The catalogue and queries are ``chip_smoke.py``'s (seed 0). ``--root``
names the checkout whose ``src/`` and ``chip_smoke.py`` are measured, so
two trees compare in one run on one card: run it for each in turn
(parent, change, change, parent). Needs a CUDA card; prints one JSON line
per row::

    python scripts/b1_rows.py --label change
    python scripts/b1_rows.py --root _checkout/parent --label parent
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ROWS = ((64, 10, None), (64, 522, None), (8, 42, ("two_level_batched",)),
        (8, 10, ("two_level_batched",)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="the checkout to measure (default: this one)")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is available")
    from repro_torch.core.engines import EngineContext
    from repro_torch.core.seplr import random_model
    from repro_torch.kernels._build import build
    from repro_torch.kernels.topk_mips import topk_mips

    gpu = cs.gpu_name_and_power()
    built = build("topk_mips")
    print(f"{args.label}: {gpu}; build {built.seconds:.1f} s\n"
          f"{built.log.strip()}", flush=True)
    dev = torch.device("cuda")
    name, m, r, dist, sparsity = cs.catalogues()[0]
    rng = np.random.default_rng(cs.SEED)
    model = random_model(rng, m, r, dist, sparsity, name=name, device=dev)
    U_all = torch.from_numpy(cs.queries(rng, cs.N_QUERIES, r, dist)).to(dev)
    cat = EngineContext(model.targets, device=dev).catalog
    for B, k, modes in ROWS:
        U = U_all[:B].contiguous()
        paths = dict(topk_mips.path_launches)
        t0 = time.perf_counter()
        recs = cs.compare_modes(cat, U, k, f"{args.label} B={B} k={k}",
                                timing=True, modes=modes or cs.MODES)
        lib = cs.timed_ms_cold(
            lambda: torch.topk(torch.matmul(U, cat.T_sorted.T), k), 10)
        ran = {p: n - paths.get(p, 0)
               for p, n in topk_mips.path_launches.items()
               if n != paths.get(p, 0)}
        args_b = cat.kernel_args(U, k, "two_level_batched")
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        for _ in range(20):
            topk_mips(**args_b)
        host_us = 1e6 * (time.perf_counter() - t_host) / 20
        torch.cuda.synchronize()
        line = {"label": args.label, "gpu": gpu, "B": B, "k": k,
                "library_ms": lib, "host_us": host_us, "paths": ran,
                "seconds": time.perf_counter() - t0,
                "modes": {mode: {key: rec[key] for key in (
                    "ms", "ms_warm", "score_ms", "walk_ms", "plain_ms",
                    "bound_ms", "bound_by", "max_abs_err",
                    "tiles_loaded_per_query", "rows_scored_per_query")}
                    for mode, rec in recs.items()}}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
