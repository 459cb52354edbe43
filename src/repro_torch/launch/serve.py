"""Serving launcher: exact top-K query serving over a SEP-LR catalogue.

``python -m repro_torch.launch.serve --targets 50000 --rank 50 --k 10 -n 200
--engine all`` builds a catalogue from ``--seed``, indexes it, and serves
batched queries through the selected engine on ``--device`` (default
``cuda``), printing the paper's efficiency metric (scores/query) next to
wall time. ``--engine all`` sweeps every exact engine of the registry
but ``auto`` and the host oracles (``naive``, ``ta``, ``bta``, ``norm``,
``norm_sharded``, ``topk_mips``) and asserts that each agrees with ``naive``; any registry
name or alias is accepted (``--engine ta`` or ``threshold`` serves the
paper's Threshold Algorithm, ``--engine fagin`` or ``partial`` a host
oracle, slowly). ``--engine auto`` warms the engines ``auto`` can pick
and reports each one it ran.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", type=int, default=20000)
    ap.add_argument("--rank", type=int, default=50)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("-n", "--num-queries", type=int, default=100)
    ap.add_argument("--batch", type=int, default=25)
    ap.add_argument("--engine", default="bta",
                    help="registry engine name/alias, or 'all' to sweep "
                         "every exact engine")
    ap.add_argument("--distribution", default="lowrank_spectrum",
                    choices=["normal", "lognormal", "lowrank_spectrum"])
    ap.add_argument("--block-size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)

    from repro_torch.core.engines import (auto_candidates, get_engine,
                                          list_engines)
    from repro_torch.core.seplr import random_model
    from repro_torch.serving.server import TopKServer

    rng = np.random.default_rng(args.seed)
    model = random_model(rng, args.targets, args.rank, args.distribution,
                         device=args.device)
    print(f"catalogue: M={args.targets} R={args.rank} "
          f"dist={args.distribution} device={args.device}; building index...")
    srv = TopKServer(model, max_batch=args.batch, block_size=args.block_size,
                     device=args.device)
    spectrum = (1.0 / np.sqrt(1.0 + np.arange(args.rank))).astype(np.float32) \
        if args.distribution == "lowrank_spectrum" else 1.0
    U = rng.standard_normal(
        (args.num_queries, args.rank)).astype(np.float32) * spectrum

    if args.engine == "all":
        # skip the host oracles (item-at-a-time loops: minutes a batch at
        # serving sizes; reachable by an explicit --engine fagin/partial)
        # and auto; naive first: it is the ground truth the others are
        # held against
        engines = [e.name for e in list_engines(exact=True)
                   if e.name != "auto" and not e.host_only]
        engines.sort(key=lambda n: n != "naive")
    else:
        engines = [get_engine(args.engine).name]
    # warm the batch sizes the chunk sequence will hit, so the reported
    # us/query is steady-state serving latency, not first-use set-up;
    # auto is warmed through the engines it can pick, the host oracles
    # not at all
    sizes = {min(args.batch, args.num_queries)}
    if args.num_queries % args.batch:
        sizes.add(args.num_queries % args.batch)
    warm = [e for e in engines if get_engine(e).has_executable]
    if "auto" in engines:
        warm = sorted(set(warm) | set(auto_candidates(srv.device)))
    if warm:
        srv.warmup(args.k, batch_sizes=sorted(sizes), engines=warm)
        print(f"warmed: {' '.join(warm)}")
    ref = None
    for eng in engines:
        res = srv.query(U, args.k, method=eng)
        vals = np.sort(np.asarray(res.values), axis=1)
        if ref is None:
            ref = vals
        elif not np.allclose(vals, ref, atol=1e-4):
            raise SystemExit(f"{eng} mismatches naive!")
        # auto's counters go to the engines it ran: report each of them
        resolved = ([name for name, st in sorted(srv.stats.items())
                     if name != "auto" and st.n_queries]
                    if eng == "auto" else [eng])
        for name in resolved:
            st = srv.stats[name]
            label = f"auto->{name}" if eng == "auto" else name
            print(f"{label:>12s}: {st.scores_per_query:10.1f} scores/query "
                  f"({st.scores_per_query / args.targets:6.2%} of naive)  "
                  f"{st.us_per_query:10.1f} us/query")


if __name__ == "__main__":
    main()
