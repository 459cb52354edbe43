"""Observability walkthrough with the PyTorch/CUDA port: traces, metrics
and the event journal under mixed traffic (DESIGN.md §14).

Runs an ``AsyncTopKServer`` through query + mutation + fault-injected
traffic, then prints the three views the obs layer provides:

1. the SPAN TREE of one slow request — queue wait, coalescing, the
   cost-table routing decision, device time, and the (snapshot version,
   mutation epoch) the scan executed against;
2. a Prometheus dump of the metrics registry (what a scraper would
   collect from this process);
3. the tail of the event journal — compactions, epoch bumps, fault
   firings and cache invalidations, carrying the same version/epoch
   join keys the spans do.

    PYTHONPATH=src python examples/observability_torch.py               # card
    PYTHONPATH=src python examples/observability_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch import obs
from repro_torch.core import SepLRModel, faults
from repro_torch.serving.pipeline import AsyncTopKServer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu runs the kernels' "
                     "plain versions)")
ap.add_argument("--targets", type=int, default=5_000,
                help="catalogue rows (default 5,000)")
args = ap.parse_args()

rng = np.random.default_rng(0)
M, R, K = args.targets, 16, 5
WAIT_S = 60

obs.reset()
obs.TRACER.sample_rate = 1.0          # demo: trace everything

model = SepLRModel(rng.standard_normal((M, R)).astype(np.float32),
                   device=args.device)
with AsyncTopKServer(model, max_batch=16, delta_capacity=32, method="bta",
                     device=args.device) as srv:
    srv.warmup(K)
    obs.reset()                        # drop warmup noise from the story

    # -- mixed traffic: queries interleaved with mutations ------------------
    print(f"catalogue: M={M} R={R} on {srv.device}; querying while "
          f"mutating (delta_capacity=32 → appends force compactions)")
    for round_ in range(3):
        handles = [srv.submit(rng.standard_normal(R).astype(np.float32),
                              K) for _ in range(24)]
        for h in handles:
            h.result(timeout=WAIT_S)
        gids = srv.add_targets(
            rng.standard_normal((20, R)).astype(np.float32))
        srv.delete_targets(gids[:5])
    # a budgeted (certificate-carrying) request and a repeated one (the
    # second hit comes straight from the result cache)
    u = rng.standard_normal(R).astype(np.float32)
    srv.submit(u, K).result(timeout=WAIT_S)
    srv.submit(u, K).result(timeout=WAIT_S)
    srv.submit(u, K, method="norm", budget=200).result(timeout=WAIT_S)

    # -- a fault: the next compaction build fails once, then recovers -------
    with faults.injected("compaction.build", error=faults.FaultInjected,
                         times=1):
        try:
            srv.add_targets(
                rng.standard_normal((40, R)).astype(np.float32))
        except faults.FaultInjected:
            pass                       # sync compaction surfaces the fault
    for _ in range(8):                 # queries keep serving through it
        srv.submit(rng.standard_normal(R).astype(np.float32),
                   K).result(timeout=WAIT_S)

    # -- view 1: the slowest request's span tree ----------------------------
    print("\n=== slowest request (span tree) ===")
    trace = obs.TRACER.slowest()
    print(trace.format_tree())

    # -- view 2: the Prometheus exposition ----------------------------------
    print("\n=== metrics (Prometheus exposition, excerpt) ===")
    prom = obs.REGISTRY.render_prom()
    wanted = ("repro_queries_total", "repro_scored_fraction_count",
              "repro_cache_lookups_total", "repro_compaction_events",
              "repro_faults_fired", "repro_epoch_bumps",
              "repro_request_latency_us_count", "repro_cost_table_us")
    for line in prom.splitlines():
        if line.startswith(wanted):
            print(line)
    n_samples = len(obs.parse_prom_text(prom))
    print(f"... ({n_samples} samples total; "
          f"obs.REGISTRY.render_prom() for the full exposition)")

    # -- view 3: the event journal tail -------------------------------------
    print("\n=== event journal (last 15) ===")
    for ev in obs.JOURNAL.tail(15):
        print(ev)

    # the join: spans carry (version, epoch); so do compaction events
    dev = trace.find("device")
    if dev is not None and "version" in dev.attrs:
        v = dev.attrs["version"]
        produced = obs.JOURNAL.events("compaction.success", version=v)
        print(f"\nslowest request ran against snapshot version {v}; "
              f"journal records {len(produced)} compaction.success "
              f"event(s) producing that version")

    obs.validate_snapshot(obs.REGISTRY.snapshot())
    print("\nmetrics snapshot validates against the checked-in schema; "
          "span store holds "
          f"{len(obs.TRACER.traces())} traces (bounded at 256)")
