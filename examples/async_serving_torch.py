"""Async micro-batching with the PyTorch/CUDA port: independent requests,
batched scans.

Boots an ``AsyncTopKServer``, fires a burst of single-query submissions
from many client threads, and prints what the pipeline did with them:
how the queue coalesced arrivals into power-of-two buckets, the
per-request latency percentiles (enqueue -> result, queue wait included),
the result cache earning hits on a repeated head query, and a mutation
invalidating those hits mid-traffic, every answer checked exact
(DESIGN.md §13). ``--shards 4`` serves over the LSM ladder, whose L1 runs
absorb the mutation as a fold.

    PYTHONPATH=src python examples/async_serving_torch.py               # card
    PYTHONPATH=src python examples/async_serving_torch.py --device cpu

On the card the dispatcher records a CUDA event after each micro-batch,
and the harvester waits on it before it copies the result to the host.
"""

import argparse
import threading
import time

import numpy as np

from repro_torch.core import SepLRModel
from repro_torch.serving.pipeline import AsyncTopKServer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu runs the kernels' "
                     "plain versions)")
ap.add_argument("--targets", type=int, default=20_000,
                help="catalogue rows (default 20,000)")
ap.add_argument("--shards", type=int, default=0,
                help="L1 runs of the LSM ladder (default 0: single level)")
args = ap.parse_args()

rng = np.random.default_rng(0)
M, R, K = args.targets, 24, 10
N_CLIENTS, PER_CLIENT = 8, 32
WAIT_S = 120

# 1) Boot and warm. The async warmup covers EVERY power-of-two bucket up
#    to max_batch: traffic decides the coalesced size.
T = rng.standard_normal((M, R)).astype(np.float32)
srv = AsyncTopKServer(SepLRModel(T, device=args.device), max_batch=16,
                      flush_ms=2.0, n_shards=args.shards,
                      device=args.device)
srv.warmup(K)
print(f"catalogue: M={M} items, R={R}, {args.shards} L1 shards; "
      f"method='auto', K={K}, on {srv.device}")

n_req = N_CLIENTS * PER_CLIENT
queries = rng.standard_normal((n_req, R)).astype(np.float32)
oracle = np.sort(queries.astype(np.float64) @ T.astype(np.float64).T,
                 axis=1)[:, ::-1][:, :K]
wrong = []

with srv:
    # 2) A burst of independent clients, one query each.
    def client(lo, hi):
        for i in range(lo, hi):
            res = srv.submit(queries[i], K).result(timeout=WAIT_S)
            if not np.allclose(res.values[0], oracle[i], atol=1e-3):
                wrong.append(i)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(j * PER_CLIENT, (j + 1) * PER_CLIENT))
               for j in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), "a client hung"
    dt = time.perf_counter() - t0
    ps = srv.pipeline_stats
    st = srv.stats["auto"]
    print(f"burst: {n_req} requests in {dt * 1e3:.0f} ms "
          f"({n_req / dt:.0f} qps), {len(wrong)} wrong")
    print(f"coalescing: {ps.n_batches} micro-batches, "
          f"mean size {ps.mean_batch_size:.1f}, "
          f"histogram {ps.batch_size_hist}")
    print(f"per-request latency: p50={st.req_p50_us / 1e3:.2f} ms "
          f"p99={st.req_p99_us / 1e3:.2f} ms")

    # 3) Head queries repeat: the result cache answers without a scan,
    #    until a mutation lands and invalidates it (the cache token
    #    carries the catalogue's version AND mutation epoch).
    hot = queries[0]
    for _ in range(5):
        srv.submit(hot, K).result(timeout=WAIT_S)
    print(f"cache: {srv.cache.hits} hits / {srv.cache.misses} misses")

    big = 100.0 * hot / np.linalg.norm(hot)
    fill = rng.standard_normal((srv.server.catalogue.delta_capacity, R)
                               ).astype(np.float32)
    gid = int(srv.add_targets(big[None])[0])
    srv.add_targets(fill)                 # overflows the delta
    res = srv.submit(hot, K).result(timeout=WAIT_S)
    if int(res.indices[0, 0]) != gid:
        wrong.append("stale cache")
    ms = srv.mutation_stats
    print(f"mutation: appended gid {gid} is instantly top-1 (cache "
          f"invalidated, re-scanned exactly); {ms['n_l1_folds']} folds, "
          f"{ms['n_compactions']} full rebuilds")

print("done — all results exact" if not wrong else f"FAILED: {wrong}")
raise SystemExit(1 if wrong else 0)
