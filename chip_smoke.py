#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and builds the port's kernels from the sources in the
checkout. In order, it

1. checks for the card and prints its name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. builds the ``topk_mips`` and ``gather_scores`` CUDA kernels (one
   ``nvcc`` each, started together) and prints nvcc's ``-Xptxas -v``
   register and shared-memory reports;
3. holds each of ``topk_mips``' three modes against its plain PyTorch
   version on the card, at the main-path shapes (the LSHTC-like
   325,056 x 100 catalogue, B = 64, k = 10, block_m 256, superblock 8),
   on the bookcrossing-like catalogue, and on two small edge cases
   (fewer real rows than k; all scores negative), and times the kernel,
   its plain version and ``torch.matmul`` + ``torch.topk``;
4. holds ``gather_scores`` (kernel B4, the ``bta`` engine's tail scorer)
   against its plain version at the tail's shape (B = 64 lanes, the
   25,600 ids of the first post-prefix block of an LSHTC-like list walk,
   repeats included), at the bookcrossing-like R = 50, and in the 1-D
   form with C not a multiple of a block's 32 rows, and times it, its
   plain version and ``torch.bmm`` over the gathered rows from a cold
   L2 (and the kernel again with a warm one);
5. drives the ``topk_mips`` path — ``TopKServer.query`` of 256 queries
   through ``topk_mips``, ``norm`` and ``naive`` on both catalogues, plus
   the kernel catalogue's single-query and pre-screen-off entry points —
   with the launch counters set to 0 just before and read just after,
   and checks that every engine agrees with ``naive`` and ``naive`` with
   a float64 host reference;
6. drives the ``bta`` path — ``TopKServer.query`` with the DEFAULT
   method, 256 queries on both catalogues plus a non-negative
   bookcrossing-like batch (the head-only sign bucket) — with the counters
   set to 0 just before and read just after; checks that ``bta`` agrees
   with ``naive``, that its tail launched ``gather_scores`` on the
   LSHTC-like run, and that the same engine on the CPU (the kernels'
   plain versions) gives the first 4 LSHTC-like queries the same values,
   ids, ``n_scored`` and ``depth``;
7. prints one ``{"kernels": [...]}`` line and, last, the device line
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
K = 10
BATCH = 64
N_QUERIES = 256
# The paper's largest experiment (its §4.4 LSHTC stand-in) and the CF
# stand-in whose norm spectrum decays steeply (§4.1 BookCrossing): the
# reference's configs/seplr_paper.py sizes, generated from SEED.
CATALOGUES = (
    ("lshtc-like", 325056, 100, "lowrank_spectrum", 0.0),
    ("bookcrossing-like", 105283, 50, "lognormal", 0.995),
)
MODES = ("two_level_batched", "two_level_tile", "single_level")
REPLACES = {
    "two_level_batched": "src/repro/kernels/topk_mips.py:387",
    "two_level_tile": "src/repro/kernels/topk_mips.py:299",
    "single_level": "src/repro/kernels/topk_mips.py:135",
    "gather_scores": "src/repro/kernels/topk_mips.py:457",
}
# the entry point of the topk_mips path that runs each mode
MODE_OF = {"topk_mips": "two_level_batched", "query": "two_level_tile",
           "prescreen_off": "single_level"}
KERNELS = ("topk_mips", "gather_scores")
N_CPU_CHECK = 4
# Scores from two fp32 summation orders over R <= 100 products differ by a
# few ulps of the largest partial sums: 1e-5 relative plus 1e-4 absolute.
RTOL, ATOL = 1e-5, 1e-4
# H100 SXM published peaks (HBM bandwidth; fp32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms_cold(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` with a cold L2: before each run
    a 256 MiB buffer is written over, evicting the 50 MB L2, and only
    ``fn`` lies between the run's two CUDA events."""
    import torch
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def ids_agree(vals_a, ids_a, vals_b, ids_b) -> bool:
    """Ids must be equal wherever the scores are distinct; a differing id
    is accepted only where both results hold (nearly) the same value and
    that value ties another slot or sits in the last slot."""
    import torch
    diff = ids_a != ids_b
    if not bool(diff.any()):
        return True
    tol = ATOL + RTOL * vals_a.abs()
    gaps = (vals_a[:, :-1] - vals_a[:, 1:]).abs()
    inf = torch.full_like(vals_a[:, :1], float("inf"))
    near = torch.minimum(torch.cat([inf, gaps], 1),
                         torch.cat([gaps, inf], 1)) <= tol
    near[:, -1] = True
    ok = ~diff | (near & ((vals_a - vals_b).abs() <= tol))
    return bool(ok.all())


def queries(rng, n, rank, distribution):
    """Queries as the serve CLI draws them."""
    import numpy as np
    spectrum = (1.0 / np.sqrt(1.0 + np.arange(rank))).astype(np.float32) \
        if distribution == "lowrank_spectrum" else 1.0
    return rng.standard_normal((n, rank)).astype(np.float32) * spectrum


def compare_modes(cat, U, k, label, timing: bool):
    """Each mode's kernel against its plain version on the same inputs."""
    import torch
    from repro_torch.kernels.topk_mips import topk_mips, topk_mips_plain
    out = {}
    for mode in MODES:
        args = cat.kernel_args(U, k, mode)
        kv, ki, ks = topk_mips(**args)
        torch.cuda.synchronize()
        pv, pi, ps = topk_mips_plain(**args)
        torch.cuda.synchronize()
        check(kv.shape == (U.shape[0], k) and bool(torch.isfinite(kv).all()),
              f"{label}/{mode}: kernel values not finite of shape [B, k]")
        err = float((kv - pv).abs().max())
        check(torch.allclose(kv, pv, rtol=RTOL, atol=ATOL),
              f"{label}/{mode}: values differ from the plain version "
              f"(max abs err {err})")
        check(ids_agree(kv, ki, pv, pi),
              f"{label}/{mode}: ids differ from the plain version")
        check(torch.equal(ks, ps),
              f"{label}/{mode}: stats differ from the plain version: "
              f"{ks[:4].tolist()} vs {ps[:4].tolist()}")
        rec = {"max_abs_err": err,
               "rows_scored_per_query": float(ks[:, 0].float().mean()),
               "tiles_loaded_per_query": float(ks[:, 2].float().mean())}
        if timing:
            R = args["T_sorted"].shape[1]
            live_rows = int(ks[:, 2].max()) * cat.block_m
            nbytes = 4 * (live_rows * R + args["U"].numel()
                          + args["tile_bounds"].numel() + U.shape[0]
                          + 2 * kv.numel() + ks.numel())
            flops = 2.0 * float(ks[:, 0].double().sum()) * R
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / FP32_FLOPS_PER_S
            rec.update(
                ms=timed_ms(lambda: topk_mips(**args), 10),
                plain_ms=timed_ms(lambda: topk_mips_plain(**args), 2),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)
        out[mode] = rec
        print(f"  {label:>18s} {mode:>17s}: max_abs_err={err:.3g} "
              + " ".join(f"{key}={rec[key]:.4g}" for key in
                         ("ms", "plain_ms", "bound_ms") if key in rec),
              flush=True)
    return out


def tail_ids(index, U, block: int, step: int):
    """The candidate ids of list-walk block ``step`` for every lane of
    ``U``: ``order_desc`` at depths ``step*block ...``, walked backwards
    in the lists where the lane's weight is negative (as the ``bta``
    tail enumerates them)."""
    import torch
    od = index.order_desc
    R, M = od.shape
    dev = od.device
    cols = torch.clamp(step * block + torch.arange(block, device=dev),
                       max=M - 1)
    cols = torch.where((U < 0)[:, :, None], M - 1 - cols, cols)
    flat = torch.arange(R, device=dev)[None, :, None] * M + cols
    return od.reshape(-1)[flat].reshape(U.shape[0], R * block).contiguous()


def compare_gather(cases):
    """``gather_scores`` against its plain version, per case; the first
    case is timed. Each tail step of the main path brings new ids, so
    ``ms``, ``plain_ms`` and ``library_ms`` start from a cold L2
    (``ms_warm`` repeats the same ids). The bound counts each distinct
    row once, with the ids, the queries and the output."""
    import torch
    from repro_torch.kernels.gather_scores import (gather_scores,
                                                   gather_scores_plain)
    out = {}
    for i, (label, T, ids, U) in enumerate(cases):
        got = gather_scores(T, ids, U)
        torch.cuda.synchronize()
        want = gather_scores_plain(T, ids, U)
        check(got.shape == ids.shape and bool(torch.isfinite(got).all()),
              f"gather_scores/{label}: not finite of the ids' shape")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"gather_scores/{label}: differs from the plain version "
              f"(max abs err {err})")
        rec = {"max_abs_err": err, "shape": list(ids.shape),
               "distinct_ids": int(torch.unique(ids).numel())}
        if i == 0:
            B, C = ids.shape
            R = T.shape[1]
            nbytes = 4 * (rec["distinct_ids"] * R + 2 * B * C + B * R)
            flops = 2.0 * B * C * R
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / FP32_FLOPS_PER_S
            ids64 = ids.long()
            rec.update(
                ms=timed_ms_cold(lambda: gather_scores(T, ids, U), 20),
                ms_warm=timed_ms(lambda: gather_scores(T, ids, U), 20),
                plain_ms=timed_ms_cold(
                    lambda: gather_scores_plain(T, ids, U), 2),
                library_ms=timed_ms_cold(
                    lambda: torch.bmm(T[ids64], U[:, :, None]), 10),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)
        out[label] = rec
        print(f"  gather_scores {label:>24s} ids {rec['shape']} "
              f"({rec['distinct_ids']} distinct): max_abs_err={err:.3g} "
              + " ".join(f"{key}={rec[key]:.4g}" for key in
                         ("ms", "ms_warm", "plain_ms", "library_ms",
                          "bound_ms")
                         if key in rec), flush=True)
    return out


def profile_chunk(srv, U) -> None:
    """Device time by kernel over one served chunk (``torch.profiler``),
    and the device's busy share of the chunk's wall time. Measurement
    only: a profiler that records no device time says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.query(U, K)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels only: an operator's row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        print("  profile: the profiler recorded no device time", flush=True)
        return
    print(f"  profile of one {U.shape[0]}-query chunk: wall {wall_us:.0f} us, "
          f"device busy {busy_us:.0f} us ({busy_us / wall_us:.1%})",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total:10.0f} us {e.count:6d} x "
              f"{e.key[:90]}", flush=True)
    b4 = [e for e in events if "gather_scores_kernel" in e.key]
    b4_us = sum(e.self_device_time_total for e in b4)
    print(f"  profile: B4 gather_scores_kernel {sum(e.count for e in b4)} "
          f"launches, {b4_us:.0f} us = {b4_us / wall_us:.2%} of the chunk's "
          f"wall", flush=True)


def edge_cases(rng, device):
    """Fewer real rows than k, and an all-negative catalogue."""
    import numpy as np
    from repro_torch.kernels.ops import MIPSCatalog
    cases = {
        "num_real<k": (rng.standard_normal((5, 17)).astype(np.float32),
                       rng.standard_normal((8, 17)).astype(np.float32)),
        "all-negative": (-np.abs(rng.standard_normal((3000, 17))).astype(
            np.float32), np.abs(rng.standard_normal((8, 17))).astype(
            np.float32)),
    }
    out = {}
    for label, (T, U) in cases.items():
        cat = MIPSCatalog(T, block_m=256, superblock=8, device=device)
        out[label] = compare_modes(cat, U, K, label, timing=False)
        vals, _, _ = cat.query_batch(U, K)
        ref = np.sort(U.astype(np.float64) @ T.T.astype(np.float64),
                      axis=1)[:, ::-1][:, :K]
        if ref.shape[1] < K:        # empty slots hold the -1e30 sentinel
            ref = np.pad(ref, ((0, 0), (0, K - ref.shape[1])),
                         constant_values=-1e30)
        check(np.allclose(vals.cpu().numpy(), ref, rtol=RTOL, atol=ATOL),
              f"{label}: kernel values differ from the float64 reference")
    return out


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("run from the root of a checkout: src/repro_torch is missing")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    gpu = gpu_name_and_power()
    print(gpu, flush=True)
    run(torch.device("cuda"), torch.cuda.get_device_name(0))


def run(dev, kind: str) -> None:
    """Every phase after the device check, on ``dev``."""
    import numpy as np
    import torch
    t_start = time.perf_counter()

    # -- build: one nvcc per kernel source, all started together -------------
    from repro_torch.kernels._build import build
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for b in pool.map(build, KERNELS):
            print(f"build: {b.path.name} in {b.seconds:.1f} s\n"
                  f"{b.log.strip()}", flush=True)

    import dataclasses
    from repro_torch.core.engines import EngineContext, get_engine
    from repro_torch.core.index import TopKIndex
    from repro_torch.core.seplr import random_model
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    from repro_torch.serving.server import TopKServer

    rng = np.random.default_rng(SEED)
    servers, U_all = {}, {}
    for name, m, r, dist, sparsity in CATALOGUES:
        t0 = time.perf_counter()
        model = random_model(rng, m, r, dist, sparsity, name=name,
                             device=dev)
        U_all[name] = queries(rng, N_QUERIES, r, dist)
        servers[name] = TopKServer(model, max_batch=BATCH,
                                   device=dev).warmup(K)
        torch.cuda.synchronize()
        print(f"{name}: M={m} R={r} built and warmed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- the kernel against its plain version on the card ---------------------
    compare = {}
    for name, *_rest in CATALOGUES:
        cat = servers[name].ctx.catalog
        U = torch.from_numpy(U_all[name][:BATCH]).to(dev)
        compare[name] = compare_modes(cat, U, K, name, timing=True)
    compare.update(edge_cases(rng, dev))
    main_cat = servers[CATALOGUES[0][0]].ctx.catalog
    U64 = torch.from_numpy(U_all[CATALOGUES[0][0]][:BATCH]).to(dev)
    library_ms = timed_ms(
        lambda: torch.topk(torch.matmul(U64, main_cat.T_sorted.T), K), 10)

    # -- kernel B4 against its plain version on the card ----------------------
    lsh, bc = (c[0] for c in CATALOGUES)
    first_tail = servers[lsh].ctx.layout("list_major").prefix_steps(
        servers[lsh].block_size)
    gather_cases = []
    for name in (lsh, bc):
        ctx = servers[name].ctx
        U = torch.from_numpy(U_all[name][:BATCH]).to(dev)
        ids = tail_ids(ctx.index, U, ctx.block_size, first_tail)
        gather_cases.append((f"{name} tail block", ctx.targets, ids, U))
    T0, ids0, U0 = gather_cases[0][1:]
    gather_cases.append(("1-D, C = 1000", T0, ids0[0, :1000].contiguous(),
                         U0[0].contiguous()))
    compare_b4 = compare_gather(gather_cases)

    # -- the topk_mips path, counted ------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    topk_mips.launches = gather_scores.launches = 0
    mode_launches = dict.fromkeys(MODES, 0)
    results = {}

    def counted(key, fn):
        before = topk_mips.launches
        results[key] = fn()
        if key[1] in MODE_OF:
            mode_launches[MODE_OF[key[1]]] += topk_mips.launches - before

    for name, srv in servers.items():
        for method in ("topk_mips", "norm", "naive"):
            counted((name, method), lambda: srv.query(
                U_all[name], K, method=method))
        cat = srv.ctx.catalog
        counted((name, "query"), lambda: cat.query(U_all[name][0], K))
        counted((name, "prescreen_off"), lambda: cat.query_batch(
            U_all[name][:BATCH], K, prescreen=False))
    torch.cuda.synchronize()
    launches = topk_mips.launches
    check(launches > 0, "the main path launched the topk_mips kernel 0 times")
    check(all(mode_launches.values()),
          f"a topk_mips mode was never launched: {mode_launches}")

    # -- the bta path (the server's default method), counted ------------------
    n_chunks = -(-N_QUERIES // BATCH)
    U_nonneg = np.abs(U_all[bc])
    runs = [(lsh, U_all[lsh], "mixed"), (bc, U_all[bc], "mixed"),
            (bc, U_nonneg, "nonneg")]
    bta_steps, bta_lat = {}, {}
    torch.cuda.synchronize()
    topk_mips.launches = gather_scores.launches = 0
    for srv in servers.values():
        srv.ctx.scan_steps.clear()
    t0 = time.perf_counter()
    for name, U, label in runs:
        srv = servers[name]
        before = dict(srv.ctx.scan_steps)
        n_lat = len(srv.stats["bta"].lat_us_ring) if "bta" in srv.stats \
            else 0
        results[name, "bta", label] = srv.query(U, K)
        bta_steps[name, label] = {key: n - before.get(key, 0)
                                  for key, n in srv.ctx.scan_steps.items()}
        bta_lat[name, label] = list(srv.stats["bta"].lat_us_ring)[n_lat:]
    torch.cuda.synchronize()
    bta_seconds = time.perf_counter() - t0
    bta_launches = gather_scores.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    lsh_tail = bta_steps[lsh, "mixed"].get("tail", 0)
    check(bta_launches > 0 and lsh_tail > 0,
          f"the LSHTC-like bta run launched gather_scores {bta_launches} "
          f"times in {lsh_tail} tail steps: its tail did not run")
    check(bta_launches == sum(st.get("tail", 0) + st.get("gather", 0)
                              for st in bta_steps.values()),
          "gather_scores launches differ from the bta tail steps")

    for name, m, r, dist, _ in CATALOGUES:
        naive = results[name, "naive"]
        U = U_all[name]
        check(naive.values.shape == (N_QUERIES, K)
              and np.isfinite(naive.values).all(),
              f"{name}: naive values are not finite of shape [256, 10]")
        exact = np.sort(U[:16].astype(np.float64)
                        @ servers[name].ctx.targets.double().cpu().numpy().T,
                        axis=1)[:, ::-1][:, :K]
        check(np.allclose(naive.values[:16], exact, rtol=RTOL, atol=ATOL),
              f"{name}: naive differs from the float64 host reference")
        tv = torch.from_numpy(naive.values)
        for method in ("topk_mips", "norm", "bta"):
            res = results[(name, method) + (("mixed",) if method == "bta"
                                            else ())]
            check(np.allclose(res.values, naive.values, rtol=RTOL, atol=ATOL),
                  f"{name}: {method} values differ from naive")
            check(ids_agree(tv, torch.from_numpy(naive.indices),
                            torch.from_numpy(res.values),
                            torch.from_numpy(res.indices)),
                  f"{name}: {method} ids differ from naive")
        v1, _, _ = results[name, "query"]
        check(np.allclose(v1.cpu().numpy(), naive.values[0], rtol=RTOL,
                          atol=ATOL), f"{name}: catalogue query() differs")
        v2, _, _ = results[name, "prescreen_off"]
        check(np.allclose(v2.cpu().numpy(), naive.values[:BATCH], rtol=RTOL,
                          atol=ATOL), f"{name}: pre-screen-off differs")
        for method in ("topk_mips", "norm", "naive"):
            st = servers[name].stats[method]
            print(f"  {name:>18s} {method:>10s}: "
                  f"{st.us_per_query:10.1f} us/query (p50 "
                  f"{st.p50_us:.1f})  {st.scores_per_query:10.1f} scores/query"
                  f" = {st.scores_per_query / m:8.4%} of M", flush=True)
    print(f"topk_mips path: topk_mips launches={launches} {mode_launches}",
          flush=True)

    # bta: agreement with naive on the non-negative batch, then the same
    # engine on the CPU for the first LSHTC-like queries
    nn_naive = servers[bc].query(U_nonneg, K, method="naive")
    nn = results[bc, "bta", "nonneg"]
    check(np.allclose(nn.values, nn_naive.values, rtol=RTOL, atol=ATOL)
          and ids_agree(torch.from_numpy(nn_naive.values),
                        torch.from_numpy(nn_naive.indices),
                        torch.from_numpy(nn.values),
                        torch.from_numpy(nn.indices)),
          f"{bc}: bta differs from naive on the non-negative batch")
    gctx = servers[lsh].ctx
    cpu_index = TopKIndex(**{f.name: getattr(gctx.index, f.name).cpu()
                             for f in dataclasses.fields(TopKIndex)})
    cpu_ctx = EngineContext(gctx.targets.cpu(), index=cpu_index,
                            block_size=gctx.block_size, device="cpu")
    t0 = time.perf_counter()
    cpu = get_engine("bta").run(cpu_ctx, U_all[lsh][:N_CPU_CHECK], K)
    cpu_seconds = time.perf_counter() - t0
    card = results[lsh, "bta", "mixed"]
    n = N_CPU_CHECK
    check(np.allclose(card.values[:n], cpu.values.numpy(), rtol=RTOL,
                      atol=ATOL)
          and ids_agree(cpu.values, cpu.indices,
                        torch.from_numpy(card.values[:n]),
                        torch.from_numpy(card.indices[:n])),
          f"{lsh}: bta on the card differs from bta on the CPU")
    for field in ("n_scored", "depth"):
        check(np.array_equal(getattr(card, field)[:n],
                             getattr(cpu, field).numpy()),
              f"{lsh}: bta {field} on the card "
              f"{getattr(card, field)[:n].tolist()} != on the CPU "
              f"{getattr(cpu, field).tolist()}")
    print(f"bta on the CPU, first {n} {lsh} queries: equal values, ids, "
          f"n_scored {cpu.n_scored.tolist()} and depth "
          f"{cpu.depth.tolist()} ({cpu_seconds:.1f} s)", flush=True)

    for name, U, label in runs:
        res = results[name, "bta", label]
        m = servers[name].ctx.num_targets
        steps = bta_steps[name, label]
        lat = bta_lat[name, label]
        print(f"  {name:>18s} bta ({label}): {np.mean(lat):10.1f} us/query "
              f"(p50 {np.median(lat):.1f})  scored share "
              f"{res.n_scored.mean() / m:8.4%} of M  depth mean "
              f"{res.depth.mean():.1f} max {res.depth.max()}  steps per "
              f"chunk {sum(steps.values()) / n_chunks:.2f} (prefix "
              f"{steps.get('prefix', 0)}, tail {steps.get('tail', 0)}, "
              f"gather {steps.get('gather', 0)})", flush=True)
    print(f"bta path: gather_scores launches={bta_launches} "
          f"topk_mips launches={topk_mips.launches} in {bta_seconds:.1f} s; "
          f"peak device memory={peak_bytes / 2**20:.1f} MiB", flush=True)
    profile_chunk(servers[lsh], U_all[lsh][:BATCH])

    def max_err(mode):
        return max(case[mode]["max_abs_err"] for case in compare.values())

    main = compare[lsh]
    kernels = {"kernels": [{
        "name": f"topk_mips[{mode}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_mips.cu",
        "replaces": REPLACES[mode],
        "launches": mode_launches[mode],
        "max_abs_err": max_err(mode),
        "ms": main[mode]["ms"],
        "plain_ms": main[mode]["plain_ms"],
        "bound_ms": main[mode]["bound_ms"],
        "bound_by": main[mode]["bound_by"],
        "library_ms": library_ms,
    } for mode in MODES]}
    b4 = next(iter(compare_b4.values()))
    kernels["kernels"].append({
        "name": "gather_scores",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gather_scores.cu",
        "replaces": REPLACES["gather_scores"],
        "launches": bta_launches,
        "max_abs_err": max(rec["max_abs_err"] for rec in compare_b4.values()),
        "ms": b4["ms"],
        "plain_ms": b4["plain_ms"],
        "bound_ms": b4["bound_ms"],
        "bound_by": b4["bound_by"],
        "library_ms": b4["library_ms"],
    })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
