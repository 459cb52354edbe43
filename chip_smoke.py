#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and builds the port's kernels from the sources in the
checkout. In order, it

1. checks for the card and prints its name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. builds the four CUDA kernel libraries (``topk_mips``,
   ``gather_scores``, ``embedding_bag``, ``fm_interaction``; one ``nvcc``
   each, started together) and prints nvcc's ``-Xptxas -v`` register and
   shared-memory reports; then makes the two catalogues and warms a
   ``TopKServer`` over each with every executable engine (one batch per
   sign bucket for ``bta`` and ``ta``; ``ta`` at the 64-query bucket
   only), printing each engine's warmup time;
3. holds each of ``topk_mips``' three modes against its plain PyTorch
   version on the card, at the main-path shapes (the LSHTC-like
   325,056 x 100 catalogue, B = 64, k = 10, block_m 256, superblock 8),
   on the bookcrossing-like catalogue, and on two small edge cases
   (fewer real rows than k; all scores negative), and times the kernel,
   each of its two phases alone (with its scratch bytes), its plain
   version and, on both catalogues, ``torch.matmul`` + ``torch.topk``;
4. holds ``gather_scores`` (kernel B4, the list engines' tail scorer)
   against its plain version at the tail's shape (B = 64 lanes, the
   25,600 ids of the first post-prefix block of an LSHTC-like list walk,
   repeats included: the lane path), at the bookcrossing-like R = 50, on
   the block's first few lanes (below ``FEW_LANES``: the row path) and in
   the 1-D form with C not a multiple of a block's 32 rows, prints the
   path each case took, and times the LSHTC-like cases, the other path
   forced, their plain version and ``torch.bmm`` over the gathered rows
   from a cold L2 (and the kernel again with a warm one); then times both
   paths, forced, on the block's first 1..64 lanes (the sweep
   ``FEW_LANES`` is read from);
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
   ids, ``n_scored`` and ``depth``; profiles one LSHTC-like ``bta``
   chunk (device activity only);
7. drives the ``ta`` path (the paper's Threshold Algorithm, 32 rounds a
   step) — ``TopKServer.query(method="ta")`` over the same batches (of
   the LSHTC-like queries only the first 64: one chunk), then one
   LSHTC-like batch halted by a budget of 4,100 rounds (inside a
   chunk, past the prefix) — with the counters set to 0 just before and
   read just after; checks that ``ta`` agrees with ``naive``, that its
   LSHTC-like tail launched ``gather_scores`` once a tail or gather step,
   that ``ta`` on the CPU gives the first 4 LSHTC-like queries the same
   values, ids, ``n_scored`` and ``depth``, exact and halted, and that no
   halted depth passes the budget; holds ``gather_scores`` against its
   plain version at ``ta``'s first LSHTC-like tail block (64 x 3,200 ids),
   timed as in 4; prints ``ta``'s latency and scored share beside
   ``bta``'s and profiles the first 8,192 rounds of a ``ta`` chunk
   (halted by a budget; device activity only);
8. the recsys serving path at DeepFM's full published width (39 fields,
   embed 10, 1,000,000 ids a field, MLP 400-400-400; random weights from
   a seeded generator on the card): holds ``embedding_bag`` (kernel B5;
   sum and mean, float32 and float16, d = 10 and d = 1) and
   ``fm_interaction`` (kernel B6; float32 and float16) against their
   plain versions at the ``serve_p99`` (512) and ``serve_bulk`` (262,144)
   batches, and times them (B5 once for each of its two calls on the
   path: forward's first-order sum at d = 1, the query tower's mean at
   d = 10); serves ``forward`` on both batch sizes with
   the counters set to 0 just before and read just after, and checks the
   first 64 logits against the same ``forward`` on the CPU; then runs the
   query tower (B5) for 64 queries, exact top-100 retrieval of 1,000,000
   candidates through ``TopKServer`` (``bta`` against ``naive``, its
   tail on B4) and ``TwoStageRanker``'s full-model re-rank to the top 5,
   counted, and holds B4 against its plain version on the retrieval's
   first tail block (R = 10, ids ``[64, 2,560]``), timed;
9. the recsys training path at DeepFM's full published width (random
   weights from SEED drawn on the card; 429,498,611 parameters, 1.72 GB)
   at the published ``train_batch`` of 65,536, with the B5 and B6
   counters set to 0 just before each counted part and read just after:
   (b) the first batch's gradient of every parameter leaf through the
   kernels (B5 and B6 in the forward, their plain-PyTorch backward) and
   through their plain versions on the card, within ``TRAIN_GRAD_TOL``
   normwise, B5 and B6 launched once; (c) the same gradient on the
   batch's first 4,096 examples on the card and on the CPU (the
   parameters copied across), within ``TRAIN_GRAD_TOL`` normwise;
   (a) a ``Trainer`` over ``PrefetchLoader(recsys_batches(SEED, ...))``
   with the launcher's AdamW (lr 3e-3, warmup 10, cosine to the run's 8
   steps) runs 8 steps: every loss finite, B5 and B6 launched once a
   step; (d) a run checkpointing every 4 steps (keep 1) into a temporary
   directory, preempted at step 6 (``SimulatedPreemption``), then a fresh
   ``Trainer`` resumed from step 4 to step 8: parameters and both moments
   bitwise equal to (a)'s, its losses of steps 5-8 equal to (a)'s (the
   step-4 save's host snapshot and write and the resume's restore
   timed);
   (e) it prints the step's median ms (steps 2-8) against its byte
   bound (``train_bounds``), peak memory, the checkpoint's seconds and
   bytes, and one profiled step (busy share, launches, time by kernel),
   with the card's name and power limit; (f) holds B5 (the first-order
   sum at d = 1) and B6 at the training batch against their plain
   versions, timed from a cold L2 with ``F.embedding_bag`` beside B5:
   two rows of the kernels line, their launches (a)'s;
10. drives ``auto`` — ``TopKServer.query(method="auto")`` over the 256
   queries of each catalogue, a 64-query request a chunk, on the servers
   whose warmup primed every engine per sign bucket — with the counters
   read around each request; checks that each chunk ran the candidate
   with the least granular prediction of the cost table it read (printed
   beside the pick), that the pick's kernel ran (B1 for ``topk_mips``,
   B4 once a list engine's tail or gather step), that ``auto`` agrees
   with ``naive``, and that a context without a cost table (the cold
   route) picks on the card what the same catalogue picks on the CPU,
   with ``norm`` read as ``topk_mips``;
11. drives the admission ladder at LSHTC-like: a server with
    ``AdmissionPolicy(degrade_budget=64)`` warmed with ``budgets=(64,)``
    (``bta`` and ``norm``), each rung forced through ``_cost_ewma`` —
    ``to_norm`` (exact, equal to ``naive``), ``to_budgeted`` (its
    certified slots a prefix of ``naive``'s top-K, ``n_uncertified``
    counted), ``shed`` by an expired deadline and by ``max_inflight=0``
    (sentinels) — then one unforced ``bta`` request whose deadline is
    twice a measured ``topk_mips`` chunk, printing the rung it took, its
    latency and ``req_p50_us``; the rungs run the ``norm`` scan, which
    has no kernel;
12. drives the host oracles through a card context: Table 1's toy
    (Fagin at depth 5 scoring 9 items, TA after 2 rounds scoring 5, best
    item 5), then 16 queries on the paper's MovieLens-1M stand-in (3,952
    x 50) through ``fagin``, ``partial`` and ``ta``: equal values, and
    ``partial``'s ``n_scored`` equal to ``ta``'s query for query, with
    each one's host time;
13. the streaming tier at LSHTC-like: a ``TopKServer`` with
    ``delta_capacity`` 256 warmed for ``topk_mips``, then, with the
    counters set to 0 just before and read just after, 64-query requests
    between mutation batches — pristine, 200 inserts, 50 updates, 100
    deletes (38 updates and the 100 deletes kill all of query 0's top
    138, so its fetch climbs 42 -> 138 -> 522, past kernel B1's
    shared-memory carry), one ``bta`` chunk (B4), the append that fills
    the delta (a synchronous compaction), a ``compact_async`` build with
    requests during it, and a build failed through
    ``faults.injected("compaction.build")`` then healed by a retry. Every
    result is held against a dense top-K over the live rows on the card;
    the first 4 queries of each request also run through the same
    schedule on a CPU catalogue, whose values, ids, ``n_scored``,
    ``depth`` and ``QueryInfo`` must equal the card's; after each build
    the version must be the expected one and
    ``engine_compiles_total`` 0. It prints us/query per request (median
    of 3), the compactions' seconds, the latency during the build and the
    launches, then holds B1 at ``k = 522`` against its plain version
    (timed, with ``torch.topk`` over the full product) and B4 at the
    ``bta`` chunk's first tail block (timed): two rows of the kernels
    line;
14. the LSM ladder behind the async front end at LSHTC-like: an
    ``AsyncTopKServer(max_batch=64, flush_ms=2, method="topk_mips",
    delta_capacity=256, n_shards=8)`` (8 L1 runs of 1,024 rows) warmed
    for ``topk_mips`` and ``norm`` at every bucket; then, with the
    counters set to 0 just before and read just after, bursts of 8 client
    threads x 16 single queries (query 0 then 5 times more, cache hits)
    between mutation rounds of 256 inserts, 16 deletes (8 L1-run rows, 8
    base rows of query 0's top 138) and 16 updates (L1-run rows) on the
    card's catalogue and a CPU ``ShardedLsmCatalogue``, until the tier
    promotes: one round's fold failed through
    ``faults.injected("compaction.fold_l1")`` and healed by the next, one
    promotion failed through ``faults.injected("compaction.promote")``
    and retried, one burst racing a mutation batch from another thread,
    and one unwarmed 64-query ``bta`` micro-batch over the L1 tier (B4).
    Every result is held against a dense top-K over the live rows on the
    card (the raced burst's against the state before or after), the
    first 4 queries of each round against the CPU catalogue (values,
    ids, ``n_scored``, ``depth``, ``QueryInfo``); each round's
    ``cache_token`` moves by its three mutation batches and its swaps
    only (no fold moves it), the hot query's repeats hit the cache and
    its first ask after a mutation misses, the fold, failure and
    compaction counts equal the CPU's and the schedule's, and
    ``engine_compiles_total`` is 0. It prints the request latencies, the
    coalescing histogram, cache hits, seconds a fold, the promotion's
    seconds, the launches, the synchronizing calls of one ``topk_mips``
    dispatch (``torch.cuda.set_sync_debug_mode``) and
    the same queries through the synchronous server; then holds B1 at
    the coalesced batch's shape (B = 8, k = 42) and B4 at the ``bta``
    micro-batch's first tail block against their plain versions, timed:
    two rows of the kernels line;
15. the sharded slice at LSHTC-like, with the counters set to 0 just
    before and read just after: (a) one 64-query chunk through
    ``TopKServer.query(method="norm_sharded")`` on the default mesh (one
    shard on the one card), exact against ``naive`` and with ``n_scored``
    and ``depth`` equal to ``norm``'s on the same chunk; (b) the four
    strategies over a ``("data",)`` mesh of 4 logical shards on the card
    — ``sharded_naive_topk``, ``sharded_blocked_topk`` (16 queries, block
    512, per-slab sorted lists; its candidates scored by kernel B4),
    ``sharded_norm_topk`` through the ``norm_sharded`` engine on a
    context whose mesh is the 4 shards — and ``hierarchical_merge_topk``
    over a ``(2, 2)`` ``("pod", "data")`` mesh, each exact against
    ``naive`` and equal (values, ids, ``n_scored``, ``depth``) to the same
    call on a CPU mesh of the same shape; (c) B4's launches on the
    blocked path (one a step), then B4 held against its plain version at
    the blocked strategy's first step (64 lanes x 51,200 ids), timed as
    in 4: a row of the kernels line; and, timed too, at the first step a
    64-query micro-batch would give it (256 lanes). It prints the
    phase's seconds;
16. the dense LM serving path at gemma-2b's full width and depth (18
    layers, d_model 2,048, MQA 8/1 at head_dim 256, GeGLU d_ff 16,384,
    vocab 256,000; 3,030,460,416 random parameters drawn on the card from
    SEED, the layer stack cast to bf16 once by ``serving_params``), with
    every kernel count set to 0 just before and read just after (each
    must stay 0: no TPU kernel is on this path): 16 prompts of 1,024
    tokens from ``lm_batches(SEED)`` through ``prefill`` (timed twice),
    then 32 greedy ``serve_step(top_k=8)`` steps, each timed on the host
    clock to a synchronize. It checks that every value is finite and
    every id in ``[0, 256000)``; that the last step's ``(values, ids)``
    agree with a witness that shares no code with the head, float64
    logits of its hidden state (``decode_hidden`` at the same position)
    and ``torch.topk``, within the fp32 product's rounding and id for id
    at every rank that rounding cannot reorder; that the decode path's
    last hidden state agrees with ``forward`` over the same 1,056 tokens
    within ``LM_TOL`` (bf16), and at fp32 on 4 prompts cut to 256 tokens
    and 4 steps; and that a 2-layer cut, drawn once on the CPU and
    copied to the card, gives the same ``prefill`` and ``serve_step``
    results (hidden state, caches, top-K values and clear ids) on the
    card as on the CPU at fp32 and bf16. It prints the prefill's ms, the
    decode step's median ms and tokens/s beside its byte bound, peak
    memory and the phase's seconds, with the card's name and power
    limit;
17. the MoE LM serving path, after gemma-2b's tensors are freed, with
    every kernel count set to 0 just before and read just after each
    part (each must stay 0: the MoE dispatch and the head are plain
    PyTorch): (a) olmoe-1b-7b at full width and depth (16 layers,
    d_model 2,048, 16 heads, 64 experts top-8, moe_d_ff 1,024, vocab
    50,304; 6,919,096,320 random parameters drawn on the card, the layer
    stack and the experts cast to bf16 once; the router stays fp32)
    served as step 16 serves gemma-2b — 16 x 1,024 prompt tokens
    prefilled (timed twice), 32 greedy ``serve_step(top_k=8)`` — checked
    the same way (finite, in range, the float64 witness), with each
    layer's drop rate at the prefill (capacity 2,560) and the steps
    (capacity 8), one step profiled, and the step's byte bound counting
    every expert's bf16 weights (the capacity buffer covers them all; the
    operations count the kept routed assignments and the prefill's causal
    half of the attention); the
    decode path against ``forward`` runs drop-free (capacity factor
    E / top_k: a step's capacity is not the forward's), at bf16 (16
    prompts, 4 steps: the last hidden state within ``LM_MOE_TOL_BF16``
    normwise and at most ``LM_MOE_FLIP_SHARE`` of the (layer, row) expert
    sets differing) and at fp32 (within ``LM_TOL``, no set differing);
    (b) a 2-layer cut drawn on the CPU and copied to the card, 4 prompts
    of 64 tokens and 2 steps, card against CPU at fp32 and bf16 (at fp32
    no token routed otherwise; at bf16 each row's first routing flip, in
    the prefill and in each step, a near-tie of the router logits within
    ``LM_MOE_TIE``, at least ``LM_MOE_CUT_SHARE`` of the prompt's
    positions before the flips, each row compared up to its first flip,
    the steps from the CPU's prefill cache on both sides over the rows
    still routed alike); (c) the same cut over 4 logical shards of the card as
    ``("data", "model")`` meshes of ``(1, 4)`` and ``(2, 2)`` —
    ``prefill`` and ``serve_step`` through the expert-parallel dispatch
    and the vocab-sharded head, against the same calls on a CPU mesh at
    fp32, the sharded head id for id the unsharded one on the same hidden
    state, and an EP step's ms beside a non-EP step's (bf16, 16 rows);
    (d) llama4-scout-17b-a16e at full width cut to 2 layers (48 layers
    are 407 GB of fp32 weights): 4 x 256 prompt tokens and 8 steps
    through top-1 routing, GQA 40/8 and the 202,048-word head, finite,
    descending and held against the float64 witness. It prints ``lm
    ...``/``lm: {json}`` lines for olmoe (drop rates, EP and non-EP step
    ms, the mesh errors) and ``lm scout: {json}``;
18. the LM training path at gemma-2b's full width and depth (3,030,460,416
    random fp32 parameters drawn on the card from SEED; bf16 compute,
    remat on, ``logit_chunk`` 512), after the serving phases' tensors
    are freed, with every kernel count set to 0 just before and read just
    after each part (each must stay 0: no TPU kernel is on this path):
    (a) the model at full width cut to 2 layers, drawn on the CPU and
    copied to the card, ``logit_chunk`` 64 over 2 x 128 tokens (2 head
    chunks) at fp32: the loss and every leaf's gradient through
    ``loss_fn`` (remat, chunks) within ``LM_TRAIN_TOL`` normwise of a
    witness on the card that shares no code with ``chunked_xent`` or the
    remat (full fp32 logits, ``F.cross_entropy``, no checkpoint) and of
    the same ``loss_fn`` on the CPU; (b) at full depth, two gradients of
    the first batch of 8 x 1,024 tokens from ``lm_batches(SEED)``, bitwise
    equal; (c) a ``Trainer`` over ``PrefetchLoader(lm_batches(...))`` with
    the launcher's AdamW (lr 3e-3, warmup 10, cosine to 8) runs 8 steps
    with no checkpoint, every loss finite; (d) at gemma-2b's smoke
    config, through the launcher's ``build``, a run checkpointing every 4
    steps (keep 1) into a temporary directory, preempted at step 6 and
    resumed from step 4, bitwise the uninterrupted run (parameters, both
    moments, the losses of steps 5-8). It prints the step's median ms
    (steps 2-8) against its bound (``lm_train_bounds``: the GEMMs' and
    the causal attention's operations at the bf16 peak plus AdamW's bytes;
    the remat's extra forward beside it), tokens/s, peak memory, one
    profiled step (busy share, launches, time by kernel and by
    ``LM_TRAIN_PROFILE_GROUPS``) and the phase's seconds, with the card's
    name and power limit (``lm train ...`` and ``lm train: {json}``);
19. prints one ``{"kernels": [...]}`` line and, last, the device line
    ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the device line.
"""

from __future__ import annotations

import contextlib
import itertools
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
# stand-in whose norm spectrum decays steeply (§4.1 BookCrossing), sized by
# repro_torch/configs/seplr_paper.py and generated from SEED; the host
# oracles run on its MovieLens-1M stand-in (3,952 x 50)
LSH, BC = "lshtc-like", "bookcrossing-like"
ORACLE_CATALOGUE = "movielens1m-like"
N_ORACLE_QUERIES = 16
MODES = ("two_level_batched", "two_level_tile", "single_level")
REPLACES = {
    "two_level_batched": "src/repro/kernels/topk_mips.py:387",
    "two_level_tile": "src/repro/kernels/topk_mips.py:299",
    "single_level": "src/repro/kernels/topk_mips.py:135",
    "gather_scores": "src/repro/kernels/topk_mips.py:457",
    "embedding_bag": "src/repro/kernels/embedding_bag.py:47",
    "fm_interaction": "src/repro/kernels/fm_interaction.py:26",
}
# the entry point of the topk_mips path that runs each mode
MODE_OF = {"topk_mips": "two_level_batched", "query": "two_level_tile",
           "prescreen_off": "single_level"}
KERNELS = ("topk_mips", "gather_scores", "embedding_bag", "fm_interaction")
N_CPU_CHECK = 4
# the ta phase's halted batch: a budget in rounds past the 2,048-round
# list prefix that stops inside a 32-round chunk
TA_BUDGET = 4100
# the profiled ta chunk stops at this many rounds (a whole chunk's trace
# took about a minute to post-process)
TA_PROFILE_ROUNDS = 8192
# the ta phase's exact LSHTC-like run: one 64-query chunk of the 256
# queries (each chunk costs seconds of host-bound steps)
TA_LSH_QUERIES = 64
# lane counts of B4's path sweep
SWEEP_LANES = (1, 2, 3, 4, 5, 6, 8, 16, 32, 64)
# Scores from two fp32 summation orders over R <= 100 products differ by a
# few ulps of the largest partial sums: 1e-5 relative plus 1e-4 absolute.
RTOL, ATOL = 1e-5, 1e-4
# The recsys path: DeepFM's published config, its serve cells' batch sizes
# (configs/base.py RECSYS_SHAPES), and the retrieval cell's catalogue.
RECSYS_ARCH = "deepfm"
SERVE_P99_BATCHES = 8
SERVE_BULK_BATCHES = 2
N_RECSYS_CPU_CHECK = 64
N_RETRIEVAL_QUERIES = 64
RETRIEVE_N = 100
RERANK_K = 5
# float16 outputs of B5 and B6 are rounded once from fp32 sums on both
# sides, so they may differ by one float16 ulp (at most 2**-10 relative):
# 2e-3 relative, plus 1e-3 of the case's largest value for outputs that
# cancel to near zero. A wrong scale or an output of zeros fails.
F16_RTOL, F16_ATOL_OF_MAX = 2e-3, 1e-3
# the two B5 calls on the recsys path, as rows of the kernels line: the
# first-order term of forward (sum over the linear weights as a [V, 1]
# table) and the query tower (mean over the embedding table)
B5_CALLS = {"embedding_bag[sum,d=1]": ("linear d=1", "sum"),
            "embedding_bag[mean,d=10]": ("embed d=10", "mean")}
# The recsys training phase: DeepFM at full width and its published
# train_batch; the launcher's AdamW over 8 steps; checkpoints every 4
# steps (keep 1) and a preemption at step 6; the card-vs-CPU gradient on
# the first 4,096 examples. Gradients are held normwise (||got - want|| /
# ||want||, a leaf at a time) to TRAIN_GRAD_TOL: the same fp32 sums in
# other orders (a kernel against its plain version, the card against the
# CPU), about 1e-7.
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 6
TRAIN_LR, TRAIN_WARMUP = 3e-3, 10
TRAIN_CPU_EXAMPLES = 4096
TRAIN_GRAD_TOL = 1e-5
# The streaming phase: the server's delta capacity, the k its escalation
# ladder reaches at K = 10 (k + 4 * 128, past the kernel's shared-memory
# carry of 256), and the most requests timed during the background build
STREAM_DELTA = 256
STREAM_LADDER_K = 522
STREAM_DURING_MAX = 64
# The LSM ladder behind the async front end: 8 L1 runs of the default
# 4 x 256 rows; bursts of 8 client threads x 16 single queries (the first
# LSM_BURST LSHTC-like queries: cut from 32 a thread for time); rounds of
# 256 inserts, 16 deletes (8 in L1 runs, 8 base rows of query 0's top 138)
# and 16 updates (of L1 rows) until the tier promotes; the round whose
# fold fails, the round after which one bta micro-batch runs over the L1
# tier, and the round whose burst races a mutation batch
LSM_SHARDS = 8
LSM_CLIENTS = 8
LSM_BURST = 128
LSM_HOT_REPEATS = 5
LSM_INSERTS, LSM_DELETES, LSM_UPDATES = 256, 16, 16
LSM_TOP = 138
LSM_FOLD_FAIL_ROUND = 2
LSM_BTA_ROUND = 16
LSM_RACE_ROUND = 8
LSM_MAX_ROUNDS = 48
LSM_WAIT_S = 300
# the coalesced batch B1 is timed at (8 closed-loop clients) and the
# tombstoned catalogue's first fetch, k + overfetch_reserve
LSM_B1_BATCH, LSM_B1_K = 8, 42
# The sharded phase: 4 logical shards on the card; the blocked strategy's
# queries and block (its flat-spectrum scan runs deep, and the CPU mesh
# replays it with B4's plain version, which materialises the gathered rows)
SHARDS = 4
SHARDED_BLOCKED_QUERIES = 16
SHARDED_BLOCK = 512
# The LM serving phase: gemma-2b at full width and depth, random weights
# drawn on the card from SEED; 16 prompts of 1,024 tokens from lm_batches,
# then 32 greedy decode steps through the exact top-8 head. Its fp32 check
# of the decode path against forward takes 4 of the prompts cut to 256
# tokens and 4 steps; its CPU check a 2-layer cut, 2 prompts of 64 tokens
# and 2 steps.
LM_ARCH, LM_PARAMS = "gemma-2b", 3_030_460_416
LM_BATCH, LM_PROMPT, LM_STEPS, LM_TOP_K = 16, 1024, 32, 8
LM_FP32_BATCH, LM_FP32_PROMPT, LM_FP32_STEPS = 4, 256, 4
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 2, 64, 2
# LM tolerances, for hidden states and KV caches normwise (||got - want|| /
# ||want||), for top-K values elementwise against the largest |want|, and
# ids compared at the slots whose logit stands clear of its neighbours by
# more than the values' tolerance. fp32 runs differ in summation order only
# (decode path against forward at depth 18, on the CPU: 8.8e-6); bf16 runs
# round at other points along the layers (the same, in bf16: 1.8-1.9%;
# an attention mask one position short gives 4.7%, a RoPE position off by
# one 11%, which the fp32 check catches at any depth).
LM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# The MoE LM phase: olmoe-1b-7b at full width and depth, served like
# gemma-2b above. Its decode-vs-forward check runs drop-free (capacity
# factor E / top_k) over 4 steps; at bf16 near-tied experts may flip
# between the two paths, so it holds the last hidden state to
# LM_MOE_TOL_BF16 (gemma's LM_TOL; 0.0258 measured) and the (layer, row)
# expert sets that differ to LM_MOE_FLIP_SHARE of all (18 of 256, 7%,
# measured; PERF.md §5). Its 2-layer cut runs 4 prompts on the CPU: at
# bf16 each row's first routing flip must be a near-tie, its k-th and
# (k+1)-th router logits within LM_MOE_TIE of the token's largest
# magnitude (the CPU tests' bf16 tolerance), and at least
# LM_MOE_CUT_SHARE of the prompt positions must precede their row's first
# flip (94 of 256, 37%, measured). Then the cut runs over 4 logical
# shards of the card as (1, 4) and (2, 2) ("data", "model") meshes, an
# EP step timed LM_MESH_STEP_REPS times. llama4-scout runs at full width
# cut to 2 layers.
MOE_ARCH, MOE_PARAMS = "olmoe-1b-7b", 6_919_096_320
LM_MOE_CHECK_STEPS = 4
LM_MOE_TOL_BF16, LM_MOE_FLIP_SHARE = 5e-2, 0.15
LM_MOE_TIE, LM_MOE_CUT_SHARE = 3e-2, 0.25
LM_MOE_CPU_BATCH = 4
LM_MESHES = ((1, 4), (2, 2))
LM_MESH_STEP_REPS = 5
SCOUT_ARCH, SCOUT_PARAMS = "llama4-scout-17b-a16e", 101_730_063_360
SCOUT_BATCH, SCOUT_PROMPT, SCOUT_STEPS = 4, 256, 8
# The LM training phase: gemma-2b at full width and depth, random fp32
# weights drawn on the card from SEED, bf16 compute, remat on, the full
# config's logit_chunk 512; LM_TRAIN_BATCH sequences of LM_TRAIN_SEQ tokens
# a step from lm_batches (cut from train_4k's 256 x 4,096: one card holds
# the state and a step of this), TRAIN_STEPS AdamW steps with the
# launcher's schedule, no checkpoint. Its check at full width cut to 2
# layers: logit_chunk 64 over LM_TRAIN_CUT_BATCH x LM_TRAIN_CUT_SEQ tokens
# (2 chunks) at fp32, the loss and every leaf's gradient within
# LM_TRAIN_TOL normwise of a witness on the card and of the CPU (fp32 sums
# in other orders: ~1e-6 on the CPU against the reference). Its resume
# runs at gemma-2b's smoke config. The bound counts the GEMMs' parameters
# (the layers' projections and the head; the embedding is a gather).
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 1024
LM_TRAIN_CUT_CHUNK, LM_TRAIN_CUT_BATCH, LM_TRAIN_CUT_SEQ = 64, 2, 128
LM_TRAIN_TOL = 1e-5
LM_MATMUL_PARAMS = 2_506_096_640
# where a profiled training step's device time goes: printed name -> a
# substring of the CUDA kernels' names (cuBLAS's Hopper GEMMs are nvjet_*)
LM_TRAIN_PROFILE_GROUPS = {"GEMMs": "nvjet", "fp32 adds": "CUDAFunctor_add",
                           "copies and casts": "copy_kernel",
                           "exp": "exp_kernel", "reductions": "reduce_kernel"}
# H100 SXM published peaks (HBM bandwidth; fp32 outside the tensor cores;
# dense bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def catalogues():
    """``(name, M, R, distribution, sparsity)`` of the two serving
    catalogues, LSHTC-like first."""
    import dataclasses
    from repro_torch.configs.seplr_paper import CF_DATASETS, LSHTC_LIKE
    return tuple(dataclasses.astuple(c) for c in
                 (LSHTC_LIKE, *(c for c in CF_DATASETS if c.name == BC)))


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


def bound(nbytes: float, flops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def compare_modes(cat, U, k, label, timing: bool, modes=MODES):
    """Each mode's kernel against its plain version on the same inputs."""
    import torch
    from repro_torch.kernels.topk_mips import topk_mips, topk_mips_plain
    out = {}
    for mode in modes:
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
            bound_ms, bound_by = bound(nbytes, flops)
            rec.update(
                ms=timed_ms_cold(lambda: topk_mips(**args), 10),
                ms_warm=timed_ms(lambda: topk_mips(**args), 10),
                plain_ms=timed_ms_cold(lambda: topk_mips_plain(**args), 2),
                bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)
            rec.update(kernel_phases(args))
        out[mode] = rec
        print(f"  {label:>18s} {mode:>17s}: max_abs_err={err:.3g} "
              + " ".join(f"{key}={rec[key]:.4g}" for key in
                         ("ms", "ms_warm", "plain_ms", "bound_ms",
                          "score_ms", "walk_ms") if key in rec),
              flush=True)
    return out


def kernel_phases(args) -> dict:
    """The ``topk_mips`` kernel's two phases timed on their own (CUDA
    events from a cold L2, mean of 10, each phase launched alone on
    buffers of the same call) and its scratch bytes. The batch must fit
    one query slice."""
    from repro_torch.kernels.topk_mips import KernelPhases
    run = KernelPhases(args["T_sorted"], args["U"], args["tile_bounds"],
                       args["live"], args["k"], args["block_m"],
                       args["mode"], args.get("superblock", 1),
                       args["num_real"])
    check(len(run.slices) == 1, "topk_mips phases: the batch needs "
          f"{len(run.slices)} query slices, not one")
    run.score()
    return {"score_ms": timed_ms_cold(run.score, 10),
            "walk_ms": timed_ms_cold(run.walk, 10),
            "scratch_bytes": run.scratch_bytes}


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
    """``gather_scores`` against its plain version, per case ``(label, T,
    ids, U, timed)``, with the path the wrapper took. A timed case's
    ``ms``, ``other_path_ms`` (the path not taken, forced), ``plain_ms``
    and ``library_ms`` start from a cold L2 (each tail step of the main
    path brings new ids; ``ms_warm`` repeats the same ids). The bound
    counts each distinct row once, with the ids, the queries and the
    output."""
    import torch
    from repro_torch.kernels.gather_scores import (gather_scores,
                                                   gather_scores_plain,
                                                   PATHS, launch_plan,
                                                   sm_count)
    out = {}
    for label, T, ids, U, timed in cases:
        got = gather_scores(T, ids, U)
        torch.cuda.synchronize()
        want = gather_scores_plain(T, ids, U)
        check(got.shape == ids.shape and bool(torch.isfinite(got).all()),
              f"gather_scores/{label}: not finite of the ids' shape")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"gather_scores/{label}: differs from the plain version "
              f"(max abs err {err})")
        ids2, U2 = (ids[None], U[None]) if ids.dim() == 1 else (ids, U)
        B, C = ids2.shape
        R = T.shape[1]
        rec = {"max_abs_err": err, "shape": list(ids.shape),
               "distinct_ids": int(torch.unique(ids).numel()),
               "path": launch_plan(B, C, R, address=T.data_ptr() % 16,
                                   sms=sm_count(T.device)).path}
        if timed:
            nbytes = 4 * (rec["distinct_ids"] * R + 2 * B * C + B * R)
            flops = 2.0 * B * C * R
            bound_ms, bound_by = bound(nbytes, flops)
            ids64 = ids2.long()
            other = next(p for p in PATHS if p != rec["path"])
            rec.update(
                ms=timed_ms_cold(lambda: gather_scores(T, ids, U), 20),
                other_path_ms=timed_ms_cold(
                    lambda: gather_scores(T, ids, U, other), 20),
                ms_warm=timed_ms(lambda: gather_scores(T, ids, U), 20),
                plain_ms=timed_ms_cold(
                    lambda: gather_scores_plain(T, ids, U), 2),
                library_ms=timed_ms_cold(
                    lambda: torch.bmm(T[ids64], U2[:, :, None]), 10),
                bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)
        out[label] = rec
        print(f"  gather_scores {label:>24s} ids {rec['shape']} "
              f"({rec['distinct_ids']} distinct), {rec['path']} path: "
              f"max_abs_err={err:.3g} "
              + " ".join(f"{key}={rec[key]:.4g}" for key in
                         ("ms", "ms_warm", "other_path_ms", "plain_ms",
                          "library_ms", "bound_ms")
                         if key in rec), flush=True)
    return out


def path_sweep(T, ids, U) -> dict:
    """Kernel B4's two paths, each forced, on the first B lanes of one
    tail block for B in ``SWEEP_LANES``: CUDA events from a cold L2, mean
    of 10. The wrapper's ``FEW_LANES`` (below it, the row path) is read
    off this table."""
    import torch
    from repro_torch.kernels.gather_scores import (FEW_LANES, PATHS,
                                                   gather_scores,
                                                   gather_scores_plain)
    out = {}
    for b in SWEEP_LANES:
        i, u = ids[:b].contiguous(), U[:b].contiguous()
        want = gather_scores_plain(T, i, u)
        ms = {}
        for path in PATHS:
            got = gather_scores(T, i, u, path)
            torch.cuda.synchronize()
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  f"gather_scores {path} path, {b} lanes: differs from the "
                  "plain version")
            ms[path] = timed_ms_cold(lambda: gather_scores(T, i, u, path), 10)
        out[b] = ms
        print(f"  gather_scores path sweep, {b:3d} lanes x {ids.shape[1]}: "
              + " ".join(f"{p} {m:.4g} ms" for p, m in ms.items()),
              flush=True)
    print(f"  gather_scores FEW_LANES = {FEW_LANES}: the row path below "
          f"{FEW_LANES} lanes, the lane path from {FEW_LANES}", flush=True)
    return out


def profile_call(label: str, fn, kernels: dict, cpu: bool = True):
    """Device time by kernel over one call of ``fn`` (``torch.profiler``),
    the device's busy share of the call's wall time, and the launches and
    share of each kernel in ``kernels`` (printed name -> a substring of
    its CUDA kernel's name). ``cpu=False`` records device activity only,
    for a call of thousands of loop steps whose host-side operator events
    would take minutes to post-process. Measurement only: a profiler that
    records no device time says so (and returns None; else the wall, busy
    and launch totals and the six costliest kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    t1 = time.perf_counter()
    # kernels only: an operator's row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    print(f"  profile of {label}: post-processed in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        print("  profile: the profiler recorded no device time", flush=True)
        return None
    print(f"  profile of {label}: wall {wall_us:.0f} us, "
          f"device busy {busy_us:.0f} us ({busy_us / wall_us:.1%}) in "
          f"{sum(e.count for e in events)} kernel launches", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total:10.0f} us {e.count:6d} x "
              f"{e.key[:90]}", flush=True)
    for name, key in kernels.items():
        mine = [e for e in events if key in e.key]
        us = sum(e.self_device_time_total for e in mine)
        print(f"  profile: {name} {sum(e.count for e in mine)} launches, "
              f"{us:.0f} us = {us / wall_us:.2%} of the wall", flush=True)
    return {"wall_us": wall_us, "busy_us": busy_us,
            "launches": sum(e.count for e in events),
            "top": [(e.key[:60], e.self_device_time_total, e.count)
                    for e in sorted(events,
                                    key=lambda e: -e.self_device_time_total)
                    [:6]]}


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


def tree_to(tree, dev):
    """A nested dict/list of tensors, copied to ``dev``."""
    if isinstance(tree, dict):
        return {key: tree_to(v, dev) for key, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def recsys_batches_on(dev, cfg, batch: int, n: int):
    """The first ``n`` click-log batches of ``batch`` rows from SEED, made
    with numpy and moved to ``dev`` (set-up, outside every timing)."""
    import torch
    from repro_torch.data.synthetic import recsys_batches
    gen = recsys_batches(SEED, cfg.n_dense, cfg.n_sparse,
                         cfg.vocab_per_field, batch)
    return [{key: torch.from_numpy(b[key]).to(dev)
             for key in ("dense", "sparse")}
            for b in itertools.islice(gen, n)]


def table_ids(cfg, batch):
    """A batch's ids as rows of the one logical table (field offsets
    added): the kernels' ``[B, F]`` int32 operand."""
    import torch
    offsets = torch.arange(cfg.n_sparse, dtype=torch.int32,
                           device=batch["sparse"].device) \
        * cfg.vocab_per_field
    return (batch["sparse"] + offsets[None, :]).contiguous()


def compare_recsys_kernels(params, ids_by_cell):
    """B5 (sum and mean over the embedding table, d = 10, and over the
    linear weights as a [V, 1] table, d = 1) and B6 (over the gathered
    field embeddings) against their plain versions, float32 and float16,
    at each cell's ids; then times both kernels, B5 in each of its two
    calls on the path (``B5_CALLS``), in float32 from a cold L2, with
    their plain versions at ``serve_bulk`` and, for B5,
    ``torch.nn.functional.embedding_bag``. Returns the ``serve_bulk``
    records of the three rows, keyed by row name."""
    import torch
    import torch.nn.functional as tnf
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    from repro_torch.kernels.fm_interaction import (fm_interaction,
                                                    fm_interaction_plain)
    from repro_torch.models.embedding import embedding_lookup
    tables = {"embed d=10": params["embed"],
              "linear d=1": params["linear"][:, None]}
    err = {"embedding_bag": {}, "fm_interaction": {}}

    def held(name, label, got, want, dtype):
        check(got.shape == want.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"{name}/{label}: not finite of the plain version's shape")
        if dtype == torch.float32:
            rtol, atol = RTOL, ATOL
        else:
            rtol = F16_RTOL
            atol = F16_ATOL_OF_MAX * float(want.float().abs().max())
        e = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), rtol=rtol,
                             atol=atol),
              f"{name}/{label}: differs from the plain version "
              f"(max abs err {e})")
        err[name][label] = e
        print(f"  {name} {label}: max_abs_err={e:.3g}", flush=True)

    for cell, ids in ids_by_cell.items():
        for dtype in (torch.float32, torch.float16):
            short = "f32" if dtype == torch.float32 else "f16"
            for tname, table in tables.items():
                t = table.to(dtype)
                for mode in ("sum", "mean"):
                    got = embedding_bag(t, ids, mode)
                    torch.cuda.synchronize()
                    held("embedding_bag", f"{cell} {tname} {mode} {short}",
                         got, embedding_bag_plain(t, ids, mode), dtype)
            emb = embedding_lookup(params["embed"], ids).to(dtype)
            got = fm_interaction(emb)
            torch.cuda.synchronize()
            held("fm_interaction", f"{cell} {tuple(emb.shape)} {short}", got,
                 fm_interaction_plain(emb), dtype)
            del emb

    recs = {}
    for cell, ids in ids_by_cell.items():
        B, F = ids.shape
        bulk = cell == "serve_bulk"
        distinct = int(torch.unique(ids).numel())
        for row, (tname, mode) in B5_CALLS.items():
            T = tables[tname]
            d = T.shape[1]
            rec = {"cell": cell, "distinct_rows": distinct,
                   "ms": timed_ms_cold(
                       lambda: embedding_bag(T, ids, mode), 20),
                   "library_ms": timed_ms_cold(
                       lambda: tnf.embedding_bag(ids, T, mode=mode), 20)}
            rec["bound_ms"], rec["bound_by"] = bound(
                4 * (B * F + distinct * d + B * d), B * F * d)
            if bulk:
                rec["plain_ms"] = timed_ms_cold(
                    lambda: embedding_bag_plain(T, ids, mode), 3)
            recs.setdefault(row, {})[cell] = rec
        emb = embedding_lookup(params["embed"], ids)
        b6 = {"cell": cell,
              "ms": timed_ms_cold(lambda: fm_interaction(emb), 20),
              "library_ms": None}
        b6["bound_ms"], b6["bound_by"] = bound(4 * (emb.numel() + B),
                                               3 * emb.numel())
        if bulk:
            b6["plain_ms"] = timed_ms_cold(
                lambda: fm_interaction_plain(emb), 3)
        del emb
        recs.setdefault("fm_interaction", {})[cell] = b6
        for row, by_cell in recs.items():
            rec = by_cell[cell]
            print(f"  {row} {cell} f32: " + " ".join(
                f"{key}={rec[key]:.4g}" for key in
                ("ms", "plain_ms", "library_ms", "bound_ms", "distinct_rows")
                if rec.get(key) is not None) + f" ({rec['bound_by']})",
                flush=True)

    def worst(name, short, part=""):
        return max(e for label, e in err[name].items()
                   if label.endswith(short) and part in label)

    f32 = {row: worst("embedding_bag", "f32", f" {tname} {mode} ")
           for row, (tname, mode) in B5_CALLS.items()}
    f32["fm_interaction"] = worst("fm_interaction", "f32")
    f16 = {name: worst(name, "f16") for name in err}
    print(f"  max_abs_err float32 {f32}, float16 {f16}", flush=True)
    return {row: {**recs[row]["serve_bulk"], "max_abs_err": f32[row]}
            for row in recs}


def recsys_path(dev):
    """Step 8 of the module docstring. Returns the kernels line's rows of
    B5 (one for each of its two calls on the path), B6 and B4 on the
    retrieval's tail block."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.seplr import SepLRModel
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.fm_interaction import fm_interaction
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.models import recsys
    from repro_torch.serving.server import TopKServer, TwoStageRanker

    spec = get_arch(RECSYS_ARCH)
    cfg = spec.make_config()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = recsys.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.param_count():,} parameters (embed "
          f"{tuple(params['embed'].shape)}) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    p99 = recsys_batches_on(dev, cfg, spec.shape("serve_p99").dims["batch"],
                            SERVE_P99_BATCHES)
    bulk = recsys_batches_on(dev, cfg,
                             spec.shape("serve_bulk").dims["batch"],
                             SERVE_BULK_BATCHES)
    print(f"recsys batches made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- kernels B5 and B6 against their plain versions -----------------------
    rows = compare_recsys_kernels(
        params, {"serve_p99": table_ids(cfg, p99[0]),
                 "serve_bulk": table_ids(cfg, bulk[0])})

    # -- serve: forward at serve_p99 and serve_bulk, counted ------------------
    recsys.forward(params, p99[-1], cfg)          # warm-up (cuBLAS, libraries)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    embedding_bag.launches = fm_interaction.launches = 0
    lat, logits = {"serve_p99": [], "serve_bulk": []}, {}
    for cell, batches in (("serve_p99", p99), ("serve_bulk", bulk)):
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            out = recsys.forward(params, batch, cfg)
            torch.cuda.synchronize()
            lat[cell].append(1e6 * (time.perf_counter() - t0))
            logits[cell, i] = out
    serve_launches = {"embedding_bag": embedding_bag.launches,
                      "fm_interaction": fm_interaction.launches}
    serve_peak = torch.cuda.max_memory_allocated()
    check(all(serve_launches.values()),
          f"the recsys serve path launched a kernel 0 times: "
          f"{serve_launches}")
    for (cell, i), out in logits.items():
        n = (p99 if cell == "serve_p99" else bulk)[i]["sparse"].shape[0]
        check(out.shape == (n,) and bool(torch.isfinite(out).all()),
              f"{cell} batch {i}: logits not finite of shape [{n}]")
    for cell, us in lat.items():
        print(f"  {cell} forward: {len(us)} batches, us per batch "
              f"p50 {np.median(us):.1f} mean {np.mean(us):.1f} "
              f"({', '.join(f'{u:.1f}' for u in us)})", flush=True)
    print(f"serve path: launches {serve_launches}; peak device memory "
          f"{serve_peak / 2**20:.1f} MiB", flush=True)

    t0 = time.perf_counter()
    n = N_RECSYS_CPU_CHECK
    cpu_logits = recsys.forward(tree_to(params, "cpu"),
                                tree_to({key: v[:n] for key, v in
                                         p99[0].items()}, "cpu"), cfg)
    card = logits["serve_p99", 0][:n].cpu()
    err = float((cpu_logits - card).abs().max())
    check(torch.allclose(card, cpu_logits, rtol=RTOL, atol=ATOL),
          f"{cfg.name}: logits on the card differ from the CPU's "
          f"(max abs err {err})")
    print(f"forward on the CPU, first {n} serve_p99 examples: max abs err "
          f"{err:.3g} against the card ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # -- retrieve and re-rank, counted ----------------------------------------
    M = spec.shape("retrieval_cand").dims["n_candidates"]
    rng = np.random.default_rng(SEED)
    cand = (rng.standard_normal((M, cfg.embed_dim)).astype(np.float32)
            * (1.0 / np.sqrt(1.0 + rng.random(M)))[:, None]
            ).astype(np.float32)
    t0 = time.perf_counter()
    server = TopKServer(SepLRModel(cand, name="items", device=dev),
                        max_batch=N_RETRIEVAL_QUERIES, device=dev).warmup(
        RETRIEVE_N, engines=["bta", "naive"])
    torch.cuda.synchronize()
    print(f"retrieval catalogue: M={M} R={cfg.embed_dim} built and warmed "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    q_host = next(recsys_batches(SEED + 7, cfg.n_dense, cfg.n_sparse,
                                 cfg.vocab_per_field, N_RETRIEVAL_QUERIES))
    queries = {key: torch.from_numpy(q_host[key]).to(dev)
               for key in ("dense", "sparse")}
    rerank_s = []

    def rerank(query_batch, cand_ids):
        # the full DeepFM forward on every (query, candidate) pair, the
        # candidate's id in the last sparse field
        t = time.perf_counter()
        B, N = cand_ids.shape
        sparse = query_batch["sparse"].repeat_interleave(N, dim=0)
        ids = torch.from_numpy(cand_ids).to(dev).reshape(-1)
        sparse[:, -1] = (ids % cfg.vocab_per_field).to(torch.int32)
        pairs = {"dense": query_batch["dense"].repeat_interleave(N, dim=0),
                 "sparse": sparse}
        out = recsys.forward(params, pairs, cfg).reshape(B, N).cpu().numpy()
        rerank_s.append(time.perf_counter() - t)
        return out

    ranker = TwoStageRanker(server, rerank, retrieve_n=RETRIEVE_N)
    torch.cuda.synchronize()
    embedding_bag.launches = fm_interaction.launches = 0
    gather_scores.launches = 0
    gather_scores.path_launches = dict.fromkeys(gather_scores.path_launches,
                                                0)
    t0 = time.perf_counter()
    U = recsys.query_tower(params, queries, cfg)
    torch.cuda.synchronize()
    tower_us = 1e6 * (time.perf_counter() - t0)
    tower_launches = embedding_bag.launches
    res, dt = {}, {}
    for method in ("bta", "naive"):
        t0 = time.perf_counter()
        res[method] = server.query(U, RETRIEVE_N, method=method)
        dt[method] = time.perf_counter() - t0
    t0 = time.perf_counter()
    top_ids, top_scores = ranker.rank(queries, U, k=RERANK_K)
    rank_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    retrieve_launches = {"embedding_bag": embedding_bag.launches,
                         "fm_interaction": fm_interaction.launches,
                         "gather_scores": gather_scores.launches}
    retrieve_paths = dict(gather_scores.path_launches)
    check(tower_launches > 0,
          "the query tower launched embedding_bag 0 times")
    check(retrieve_launches["embedding_bag"] > tower_launches,
          "the re-rank's forward launched embedding_bag 0 times")
    check(all(retrieve_launches.values()),
          f"retrieve and re-rank launched a kernel 0 times: "
          f"{retrieve_launches}")

    check(U.shape == (N_RETRIEVAL_QUERIES, cfg.embed_dim)
          and bool(torch.isfinite(U).all()),
          "query tower output not finite of shape [64, 10]")
    bta, naive = res["bta"], res["naive"]
    check(naive.values.shape == (N_RETRIEVAL_QUERIES, RETRIEVE_N)
          and np.isfinite(naive.values).all(),
          "naive retrieval values not finite of shape [64, 100]")
    check(np.allclose(bta.values, naive.values, rtol=RTOL, atol=ATOL)
          and ids_agree(torch.from_numpy(naive.values),
                        torch.from_numpy(naive.indices),
                        torch.from_numpy(bta.values),
                        torch.from_numpy(bta.indices)),
          "bta retrieval differs from naive")
    exact = np.sort(U[:8].double().cpu().numpy() @ cand.astype(np.float64).T,
                    axis=1)[:, ::-1][:, :RETRIEVE_N]
    check(np.allclose(naive.values[:8], exact, rtol=RTOL, atol=ATOL),
          "naive retrieval differs from the float64 host reference")
    check(top_ids.shape == (N_RETRIEVAL_QUERIES, RERANK_K)
          and np.isfinite(top_scores).all()
          and (np.diff(top_scores, axis=1) <= 0).all(),
          "re-ranked top-5 not finite, sorted, of shape [64, 5]")
    check(all(set(top_ids[b]) <= set(bta.indices[b])
              for b in range(N_RETRIEVAL_QUERIES)),
          "a re-ranked id is not among the retrieved candidates")
    again = rerank(queries, top_ids)
    check(np.allclose(again, top_scores, rtol=RTOL, atol=ATOL),
          "re-rank scores differ from the forward of the chosen pairs")
    t0 = time.perf_counter()
    rerank(queries, bta.indices)
    rerank_warm_ms = 1e3 * (time.perf_counter() - t0)
    share = float(bta.n_scored.mean()) / M
    for method in ("bta", "naive"):
        print(f"  retrieval_cand {method}: "
              f"{1e6 * dt[method] / N_RETRIEVAL_QUERIES:.1f} us/query "
              f"(one {N_RETRIEVAL_QUERIES}-query batch), scored share "
              f"{float(res[method].n_scored.mean()) / M:.4%} of M, depth "
              f"mean {float(res[method].depth.mean()):.1f}", flush=True)
    print(f"  query tower: {tower_us:.1f} us for {N_RETRIEVAL_QUERIES} "
          f"queries; TwoStageRanker.rank {1e3 * rank_s:.1f} ms, of it the "
          f"re-rank of {N_RETRIEVAL_QUERIES} x {RETRIEVE_N} pairs "
          f"{1e3 * rerank_s[0]:.1f} ms (the first forward at that shape; "
          f"again on the same pairs {rerank_warm_ms:.1f} ms)", flush=True)
    print(f"retrieve path: launches {retrieve_launches} (query tower "
          f"{tower_launches}; gather_scores by path {retrieve_paths}); bta "
          f"scored share {share:.4%}", flush=True)
    for cell, batch in (("serve_p99", p99[0]), ("serve_bulk", bulk[0])):
        profile_call(f"one {cell} forward",
                     lambda: recsys.forward(params, batch, cfg),
                     {"B5 embedding_bag_*_kernel": "embedding_bag_",
                      "B6 fm_interaction_kernel": "fm_interaction_kernel"})

    # forward launches B5 only in sum mode over the linear weights, the
    # query tower only in mean mode: each row's launches on the path
    launches = {
        "embedding_bag[sum,d=1]": serve_launches["embedding_bag"]
        + retrieve_launches["embedding_bag"] - tower_launches,
        "embedding_bag[mean,d=10]": tower_launches,
        "fm_interaction": serve_launches["fm_interaction"]
        + retrieve_launches["fm_interaction"]}
    # kernel B4 on the retrieval's first tail block (R = 10), after the
    # counted run
    ctx = server.ctx
    first_tail = ctx.layout("list_major").prefix_steps(ctx.block_size)
    label = f"retrieval tail block, R = {cfg.embed_dim}"
    ids = tail_ids(ctx.index, U, ctx.block_size, first_tail)
    b4 = compare_gather([(label, ctx.targets, ids, U, True)])[label]
    return [{
        "name": row,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{row.split('[')[0]}.cu",
        "replaces": REPLACES[row.split("[")[0]],
        "launches": launches[row],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    } for row, rec in rows.items()] + [
        b4_row(f"gather_scores[R={cfg.embed_dim}]", b4,
               retrieve_launches["gather_scores"], b4["max_abs_err"])
    ]


def train_bounds(cfg, B: int, distinct: int) -> dict:
    """The least time of one training step of batch ``B`` whose ids reach
    ``distinct`` rows: bytes each input once and each output once over
    the HBM rate, against the fp32 operations of the MLP's products (one
    in the forward, two in the backward). The bytes: AdamW reads the
    parameters, the gradient and both moments and writes the parameters
    and both moments (every leaf is dense, the embedding's too: 7 x the
    parameters' bytes); the dense gradient is zeroed (its bytes once
    more) and the distinct rows scattered into it; the ids and labels are
    read, and the distinct embedding and linear rows gathered once. That
    is the bound of a step with a materialised dense gradient, as the
    port's and the reference's are; ``fused_bytes_ms`` is the floor of
    one that folds the sparse gradient into the optimizer: 6 passes
    (read and write the parameters and both moments) and the rows."""
    p_bytes = 4 * cfg.param_count()
    rows = 4 * distinct * (cfg.embed_dim + 1)
    io_bytes = 2 * rows + 4 * B * (cfg.n_sparse + 1)
    step_bytes = 8 * p_bytes + io_bytes
    dims = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims + (1,)
    ops = 6 * B * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    bytes_ms = 1e3 * step_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_FLOPS_PER_S
    return {"step_bytes": step_bytes, "param_bytes": p_bytes,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "fused_bytes_ms":
            1e3 * (6 * p_bytes + io_bytes) / HBM_BYTES_PER_S,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def train_path(dev) -> list:
    """Step 9 of the module docstring. Returns the kernels line's rows of
    B5 (the first-order sum at d = 1) and B6 on the training path."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.configs import get_arch
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    from repro_torch.kernels.fm_interaction import (fm_interaction,
                                                    fm_interaction_plain)
    from repro_torch.models import recsys
    from repro_torch.models.embedding import embedding_lookup
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import (SimulatedPreemption, Trainer,
                                           TrainerConfig)
    from repro_torch.train.tree import tree_leaves

    t_phase = time.perf_counter()
    spec = get_arch(RECSYS_ARCH)
    cfg = spec.make_config()
    B = spec.shape("train_batch").dims["batch"]
    opt = OptimizerConfig(kind="adamw", lr=TRAIN_LR,
                          warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return recsys.init_params(cfg, gen, device=dev)

    def stream():
        return recsys_batches(SEED, cfg.n_dense, cfg.n_sparse,
                              cfg.vocab_per_field, B)

    def loss(p, b):
        return recsys.loss_fn(p, b, cfg)

    def worst(got, want):
        errs = {key: normwise(got[key], want[key]) for key in want}
        return max(errs.values()), errs

    @contextlib.contextmanager
    def indexed(taken=None):
        """``forward`` over plain advanced indexing and the plain B6: the
        field lookup and the first-order bag read ``table[ids]``, whose
        gradient is PyTorch's own scatter, not ``row_grad``. With a dict
        ``taken``, the gathered rows are detached leaves stored there
        (``"embed"`` ``[B, F, d]``, ``"linear"`` ``[B, F, 1]``)."""
        def rows(key, table, ids):
            got = table[ids.long()]
            if taken is not None:
                got = taken[key] = got.detach().requires_grad_()
            return got

        saved = (recsys.embedding_lookup, recsys.embedding_bag,
                 recsys.fm_interaction)
        recsys.embedding_lookup = lambda t, i: rows("embed", t, i)
        recsys.embedding_bag = lambda t, i, mode: rows("linear", t, i).sum(1)
        recsys.fm_interaction = fm_interaction_plain
        try:
            yield
        finally:
            (recsys.embedding_lookup, recsys.embedding_bag,
             recsys.fm_interaction) = saved

    def scatter_witness(params, batch):
        """The ``embed`` and ``linear`` gradients summed in float64 on the
        CPU by ``index_add_`` from the loss's gradient at each gathered
        row: a witness of the tables' scatter independent of
        ``row_grad``."""
        taken = {}
        with indexed(taken):
            value, _ = recsys.loss_fn(params, batch, cfg)
        ids = recsys._sparse_ids(params, batch, cfg).reshape(-1).long()
        out = {}
        for key, g in zip(taken, torch.autograd.grad(value,
                                                     list(taken.values()))):
            table = params[key]
            g = g.reshape(ids.numel(), -1)
            w = torch.zeros((table.shape[0], g.shape[1]),
                            dtype=torch.float64)
            out[key] = w.index_add_(0, ids.cpu(),
                                    g.double().cpu()).reshape(table.shape)
        return out

    first = next(stream())
    batch = {key: torch.from_numpy(v).to(dev) for key, v in first.items()}

    # -- (b) the gradient through the kernels and through the plain versions
    params = fresh()
    torch.cuda.synchronize()
    zero_counters()
    _, g_kernel = grads(loss, params, batch)
    torch.cuda.synchronize()
    grad_launches = read_counters()
    check(grad_launches["embedding_bag"] == 1
          and grad_launches["fm_interaction"] == 1,
          f"one gradient launched B5/B6 {grad_launches}, not once each")
    with indexed():
        _, g_plain = grads(loss, params, batch)
    err_plain, errs = worst(g_kernel, g_plain)
    print(f"train: gradient through the kernels vs the plain versions "
          f"over advanced indexing on the card, normwise by leaf: "
          f"{json.dumps(errs)}", flush=True)
    check(err_plain <= TRAIN_GRAD_TOL,
          f"the kernel path's gradient differs from the plain path's "
          f"({err_plain:.3g} normwise)")
    del g_kernel, g_plain

    # -- (c) the card against the CPU on the first examples -----------------
    n = TRAIN_CPU_EXAMPLES
    t0 = time.perf_counter()
    _, g_card = grads(loss, params,
                      {key: v[:n] for key, v in batch.items()})
    cpu_params = tree_to(params, "cpu")
    cpu_batch = {key: torch.from_numpy(v[:n]) for key, v in first.items()}
    _, g_cpu = grads(loss, cpu_params, cpu_batch)
    err_cpu, errs = worst(g_card, g_cpu)
    print(f"train: gradient on the card vs the CPU, first {n} examples, "
          f"normwise by leaf ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(errs)}", flush=True)
    check(err_cpu <= TRAIN_GRAD_TOL,
          f"the card's gradient differs from the CPU's ({err_cpu:.3g} "
          f"normwise)")
    witness = scatter_witness(cpu_params, cpu_batch)
    err_witness = {f"{side} {key}": normwise(g[key], w)
                   for key, w in witness.items()
                   for side, g in (("card", g_card), ("cpu", g_cpu))}
    print(f"train: the tables' gradients vs a float64 index_add_ witness, "
          f"first {n} examples, normwise: {json.dumps(err_witness)}",
          flush=True)
    check(max(err_witness.values()) <= TRAIN_GRAD_TOL,
          f"the tables' gradients differ from the float64 witness "
          f"{err_witness}")
    del g_card, g_cpu, params, cpu_params, witness

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        print(f"train: checkpoints under a temporary directory with "
              f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free",
              flush=True)
        # -- (a) eight steps through Trainer, counted ----------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        full = Trainer(loss, fresh(), opt, PrefetchLoader(stream),
                       TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                     ckpt_every=TRAIN_STEPS + 1))
        zero_counters()
        t0 = time.perf_counter()
        full.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()
        full.data.close()
        losses = [h["loss"] for h in full.history]
        check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
              f"training losses not finite: {losses}")
        check(launches["embedding_bag"] == TRAIN_STEPS
              and launches["fm_interaction"] == TRAIN_STEPS,
              f"{TRAIN_STEPS} steps launched B5/B6 {launches}, not once a "
              f"step each")
        step_ms = [1e3 * h["step_time"] for h in full.history]

        # -- (d) preempted at step 6, resumed from step 4 ------------------
        ck = os.path.join(tmp, "ckpt")
        cfg_ck = dict(total_steps=TRAIN_STEPS, log_every=1,
                      ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ck, keep_ckpts=1)
        io_s = {"save": [], "restore": []}

        def timed(kind, fn):
            """``fn`` recording its (start, end) host times in io_s."""
            def call(*args, **kw):
                t = time.perf_counter()
                out = fn(*args, **kw)
                io_s[kind].append((t, time.perf_counter()))
                return out
            return call

        cut = Trainer(loss, fresh(), opt, PrefetchLoader(stream),
                      TrainerConfig(fail_at_step=TRAIN_FAIL_AT, **cfg_ck))
        cut.manager.save = timed("save", cut.manager.save)
        t0 = time.perf_counter()
        try:
            cut.run()
            fail(f"no preemption at step {TRAIN_FAIL_AT}")
        except SimulatedPreemption:
            pass
        cut.manager.wait()      # the step-4 write the preemption left
        t_written = time.perf_counter()
        cut.data.close()
        cut_s = t_written - t0
        (s0, s1), = io_s["save"]
        snapshot_s, write_s = s1 - s0, t_written - s1
        check(cut.manager.list_steps() == [TRAIN_CKPT_EVERY],
              f"checkpoints after the preemption: {cut.manager.list_steps()}")
        del cut
        resumed = Trainer(loss, fresh(), opt, PrefetchLoader(stream),
                          TrainerConfig(**cfg_ck))
        resumed.manager.restore = timed("restore", resumed.manager.restore)
        t0 = time.perf_counter()
        resumed.run()
        resume_s = time.perf_counter() - t0
        resumed.data.close()
        check(resumed.step == TRAIN_STEPS and
              resumed.history[0]["step"] == TRAIN_CKPT_EVERY + 1,
              "the resumed run did not start from the step-4 checkpoint")
        state = {"params": resumed.params, "opt": resumed.opt_state}
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state),
            tree_leaves({"params": full.params, "opt": full.opt_state}))),
              "the resumed run's parameters and moments are not bitwise "
              "those of the uninterrupted run")
        check([h["loss"] for h in resumed.history] ==
              losses[TRAIN_CKPT_EVERY:],
              "the resumed run's losses differ from the uninterrupted run's")
        check(resumed.manager.list_steps() == [TRAIN_STEPS],
              f"checkpoints kept: {resumed.manager.list_steps()}")
        (r0, r1), = io_s["restore"]
        restore_s = r1 - r0
        with open(os.path.join(ck, f"step_{TRAIN_STEPS:010d}",
                               "manifest.json")) as f:
            ck_bytes = json.load(f)["nbytes"]
        del resumed, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- (e) the step against its bound, one step profiled ------------------
    ids = table_ids(cfg, batch)
    distinct = int(torch.unique(ids).numel())
    bounds = train_bounds(cfg, B, distinct)
    med = float(np.median(step_ms[1:]))
    gpu = gpu_name_and_power()
    print(f"train {cfg.name} at {gpu}: {TRAIN_STEPS} steps of {B} examples "
          f"in {run_s:.1f} s, losses {[round(x, 6) for x in losses]}; step "
          f"ms median of steps 2-{TRAIN_STEPS} {med:.3f} (all "
          f"{[round(x, 3) for x in step_ms]}), {B / med * 1e3:.0f} "
          f"examples/s; byte bound with a materialised dense gradient "
          f"{bounds['bytes_ms']:.3f} ms ({bounds['step_bytes'] / 1e9:.3f} "
          f"GB; {bounds['fused_bytes_ms']:.3f} ms with the sparse gradient "
          f"folded into the optimizer), operations "
          f"{bounds['ops_ms']:.3f} ms: {med / bounds['bound_ms']:.1f}x the "
          f"bound; peak device memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"train: checkpoint {ck_bytes / 1e9:.3f} GB: the step-4 save's "
          f"host snapshot {snapshot_s:.2f} s (the step waits for it), its "
          f"write on the writer thread done {write_s:.2f} s after it "
          f"(overlapping steps 5-6); the resumed run's restore "
          f"{restore_s:.2f} s; the preempted run {cut_s:.1f} s, the resumed "
          f"run {resume_s:.1f} s", flush=True)
    print("train: " + json.dumps({
        "step_ms_median": med, "step_ms": step_ms, "bound_ms":
        bounds["bound_ms"], "bytes_ms": bounds["bytes_ms"], "ops_ms":
        bounds["ops_ms"], "step_bytes": bounds["step_bytes"],
        "peak_bytes": peak, "ckpt_bytes": ck_bytes, "snapshot_s":
        snapshot_s, "write_s": write_s, "restore_s": restore_s, "grad_err_plain": err_plain,
        "grad_err_cpu": err_cpu, "grad_err_witness": err_witness,
        "fused_bytes_ms": bounds["fused_bytes_ms"], "launches": launches}),
          flush=True)
    profile_call("one DeepFM training step", lambda: full.train_step(
        full.params, full.opt_state, batch),
                 {"B5 embedding_bag_*_kernel": "embedding_bag_",
                  "B6 fm_interaction_kernel": "fm_interaction_kernel"})

    # -- (f) B5 and B6 at the training batch, timed -------------------------
    params = full.params
    T = params["linear"][:, None]
    emb = embedding_lookup(params["embed"], ids)
    got, want = embedding_bag(T, ids, "sum"), embedding_bag_plain(T, ids)
    torch.cuda.synchronize()
    e5 = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
          f"B5 at the training batch differs from its plain version ({e5})")
    got, want = fm_interaction(emb), fm_interaction_plain(emb)
    torch.cuda.synchronize()
    e6 = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
          f"B6 at the training batch differs from its plain version ({e6})")
    F = cfg.n_sparse
    b5 = {"ms": timed_ms_cold(lambda: embedding_bag(T, ids, "sum"), 20),
          "plain_ms": timed_ms_cold(lambda: embedding_bag_plain(T, ids), 3),
          "library_ms": timed_ms_cold(
              lambda: tnf.embedding_bag(ids, T, mode="sum"), 20)}
    b5["bound_ms"], b5["bound_by"] = bound(4 * (B * F + distinct + B), B * F)
    b6 = {"ms": timed_ms_cold(lambda: fm_interaction(emb), 20),
          "plain_ms": timed_ms_cold(lambda: fm_interaction_plain(emb), 3),
          "library_ms": None}
    b6["bound_ms"], b6["bound_by"] = bound(4 * (emb.numel() + B),
                                           3 * emb.numel())
    for name, rec in (("B5 sum d=1", b5), ("B6", b6)):
        print(f"  train {name} at {B}: " + " ".join(
            f"{key}={rec[key]:.4g}" for key in ("ms", "plain_ms",
                                                "library_ms", "bound_ms")
            if rec[key] is not None) + f" ({rec['bound_by']})", flush=True)
    print(f"train phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return [{"name": f"{name}[train{label}]", "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": err, **rec}
            for name, label, err, rec in (
                ("embedding_bag", ",sum,d=1", e5, b5),
                ("fm_interaction", "", e6, b6))]


def ta_path(servers, U_all, results, bta_depth, cpu_ctx) -> dict:
    """Step 7 of the module docstring. ``results`` holds the ``naive``
    results of the served batches, ``bta_depth`` the LSHTC-like ``bta``
    depths, ``cpu_ctx`` the LSHTC-like catalogue on the CPU. Returns the
    kernels line's row of B4 at ``ta``'s tail block."""
    import numpy as np
    import torch
    from repro_torch.core.engines import EngineContext, get_engine
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    lsh, bc = LSH, BC
    runs = [(lsh, U_all[lsh][:TA_LSH_QUERIES], "mixed", None),
            (bc, U_all[bc], "mixed", None),
            (bc, np.abs(U_all[bc]), "nonneg", None),
            (lsh, U_all[lsh][:BATCH], "halted", TA_BUDGET)]
    steps, lat, res = {}, {}, {}
    torch.cuda.synchronize()
    topk_mips.launches = gather_scores.launches = 0
    gather_scores.path_launches = dict.fromkeys(gather_scores.path_launches,
                                                0)
    for srv in servers.values():
        srv.ctx.scan_steps.clear()
    t0 = time.perf_counter()
    for name, U, label, budget in runs:
        srv = servers[name]
        before = dict(srv.ctx.scan_steps)
        ring = srv.stats["ta"].lat_us_ring if "ta" in srv.stats else ()
        n_lat = len(ring)
        res[label, name] = srv.query(U, K, method="ta", budget=budget)
        steps[label, name] = {key: n - before.get(key, 0)
                              for key, n in srv.ctx.scan_steps.items()}
        lat[label, name] = list(srv.stats["ta"].lat_us_ring)[n_lat:]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gather_scores.launches
    path_launches = dict(gather_scores.path_launches)
    lsh_tail = steps["mixed", lsh].get("tail", 0)
    check(launches > 0 and lsh_tail > 0,
          f"the LSHTC-like ta run launched gather_scores {launches} times "
          f"in {lsh_tail} tail steps: its tail did not run")
    check(launches == sum(st.get("tail", 0) + st.get("gather", 0)
                          for st in steps.values()),
          "gather_scores launches differ from the ta tail and gather steps")
    check(topk_mips.launches == 0, "the ta path launched topk_mips")

    for label, name, naive in (("mixed", lsh, results[lsh, "naive"]),
                               ("mixed", bc, results[bc, "naive"]),
                               ("nonneg", bc, results[bc, "naive",
                                                      "nonneg"])):
        got = res[label, name]
        n = got.values.shape[0]
        check(np.allclose(got.values, naive.values[:n], rtol=RTOL,
                          atol=ATOL)
              and ids_agree(torch.from_numpy(naive.values[:n]),
                            torch.from_numpy(naive.indices[:n]),
                            torch.from_numpy(got.values),
                            torch.from_numpy(got.indices)),
              f"{name}: ta differs from naive ({label} batch)")
    halted = res["halted", lsh]
    check(int(halted.depth.max()) <= TA_BUDGET,
          f"a halted ta depth {int(halted.depth.max())} passes the budget "
          f"{TA_BUDGET}")
    check(bool((halted.depth == TA_BUDGET).any()),
          f"no LSHTC-like ta query ran to the budget {TA_BUDGET}")

    # ta on the CPU (the kernels' plain versions): the first queries,
    # exact and halted
    n = N_CPU_CHECK
    for label, budget in (("mixed", None), ("halted", TA_BUDGET)):
        t0 = time.perf_counter()
        cpu = get_engine("ta").run(cpu_ctx, U_all[lsh][:n], K, budget=budget)
        cpu_s = time.perf_counter() - t0
        card = res[label, lsh]
        check(np.allclose(card.values[:n], cpu.values.numpy(), rtol=RTOL,
                          atol=ATOL)
              and ids_agree(cpu.values, cpu.indices,
                            torch.from_numpy(card.values[:n]),
                            torch.from_numpy(card.indices[:n])),
              f"{lsh}: ta ({label}) on the card differs from the CPU")
        for field in ("n_scored", "depth"):
            check(np.array_equal(getattr(card, field)[:n],
                                 getattr(cpu, field).numpy()),
                  f"{lsh}: ta ({label}) {field} on the card "
                  f"{getattr(card, field)[:n].tolist()} != on the CPU "
                  f"{getattr(cpu, field).tolist()}")
        print(f"ta ({label}) on the CPU, first {n} {lsh} queries: equal "
              f"values, ids, n_scored {cpu.n_scored.tolist()} and depth "
              f"{cpu.depth.tolist()} ({cpu_s:.1f} s)", flush=True)

    for label, name in steps:
        got = res[label, name]
        m = servers[name].ctx.num_targets
        st = steps[label, name]
        chunks = -(-got.depth.shape[0] // BATCH)
        print(f"  {name:>18s} ta ({label}): {np.mean(lat[label, name]):10.1f}"
              f" us/query (p50 {np.median(lat[label, name]):.1f})  scored "
              f"share {got.n_scored.mean() / m:8.4%} of M  depth mean "
              f"{got.depth.mean():.1f} max {got.depth.max()}  steps per "
              f"chunk {sum(st.values()) / chunks:.2f} (prefix "
              f"{st.get('prefix', 0) / chunks:.2f}, tail "
              f"{st.get('tail', 0) / chunks:.2f}, gather "
              f"{st.get('gather', 0) / chunks:.2f})", flush=True)
    depth = res["mixed", lsh].depth
    bta_depth = bta_depth[:depth.shape[0]]
    print(f"ta path: gather_scores launches={launches} (by path "
          f"{path_launches}) in {seconds:.1f} s; {lsh} queries whose ta "
          f"depth <= their bta depth: {np.mean(depth <= bta_depth):.2%} "
          f"(ta depth mean {depth.mean():.1f}, bta {bta_depth.mean():.1f})",
          flush=True)
    profile_call(f"the first {TA_PROFILE_ROUNDS} rounds of one "
                 f"{BATCH}-query {lsh} ta chunk (device activity only)",
                 lambda: servers[lsh].query(U_all[lsh][:BATCH], K,
                                            method="ta",
                                            budget=TA_PROFILE_ROUNDS),
                 {"B4 gather_scores_*_kernel": "gather_scores_"}, cpu=False)

    # kernel B4 at ta's first LSHTC-like tail block, after the counted run
    ctx = servers[lsh].ctx
    U = torch.from_numpy(U_all[lsh][:BATCH]).to(ctx.device)
    chunk = ctx.ta_chunk
    ids = tail_ids(ctx.index, U, chunk,
                   ctx.layout("list_major").prefix_steps(chunk))
    label = f"{lsh} ta tail block"
    rec = compare_gather([(label, ctx.targets, ids, U, True)])[label]
    return b4_row("gather_scores[ta tail]", rec, path_launches["lanes"],
                  rec["max_abs_err"])


def agrees_with(got, want) -> bool:
    """Values within tolerance and ids equal wherever scores are distinct,
    of two host results."""
    import numpy as np
    import torch
    return bool(np.allclose(got.values, want.values, rtol=RTOL, atol=ATOL)
                and ids_agree(torch.from_numpy(want.values),
                              torch.from_numpy(want.indices),
                              torch.from_numpy(got.values),
                              torch.from_numpy(got.indices)))


def auto_path(servers, U_all, results, cpu_ctxs) -> None:
    """Step 10 of the module docstring. ``results`` holds the ``naive``
    results of the served batches, ``cpu_ctxs`` each catalogue on the
    CPU."""
    import numpy as np
    import torch
    from repro_torch.core.engines import (EngineContext, auto_candidates,
                                          cost_label, get_engine,
                                          select_engine)
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    torch.cuda.synchronize()
    topk_mips.launches = gather_scores.launches = 0
    picks = {}
    for name, srv in servers.items():
        ctx, ct = srv.ctx, srv.cost_table
        cands = auto_candidates(ctx.device)
        outs = []
        for i in range(0, N_QUERIES, BATCH):
            chunk = U_all[name][i:i + BATCH]
            pred = {c: ct.predict(c, BATCH,
                                  cost_label(get_engine(c), ctx, chunk),
                                  granular_only=True) for c in cands}
            check(all(v is not None for v in pred.values()),
                  f"{name}: the warmup left an auto candidate unprimed: "
                  f"{pred}")
            want = min(cands, key=lambda c: pred[c])
            served = {e: st.n_queries for e, st in srv.stats.items()}
            steps = dict(ctx.scan_steps)
            b1, b4 = topk_mips.launches, gather_scores.launches
            t0 = time.perf_counter()
            outs.append(srv.query(chunk, K, method="auto"))
            us = 1e6 * (time.perf_counter() - t0) / BATCH
            ran = [e for e, st in srv.stats.items()
                   if st.n_queries > served.get(e, 0)]
            check(ran == [want], f"{name}: auto ran {ran} where the table "
                  f"it read predicts {want} cheapest: {pred}")
            b1, b4 = topk_mips.launches - b1, gather_scores.launches - b4
            tail = sum(ctx.scan_steps[key] - steps.get(key, 0)
                       for key in ("tail", "gather"))
            if want == "topk_mips":
                check(b1 > 0 and b4 == 0,
                      f"{name}: auto -> topk_mips launched B1 {b1} times")
            elif want in ("bta", "ta"):
                check(b4 == tail and b1 == 0,
                      f"{name}: auto -> {want} launched B4 {b4} times in "
                      f"{tail} tail steps")
            else:
                check(b1 == b4 == 0, f"{name}: auto -> {want} launched a "
                      "kernel")
            picks[name, i // BATCH] = want
            print(f"  {name:>18s} auto chunk {i // BATCH}: {want} "
                  f"({us:.1f} us/query; B1 {b1}, B4 {b4} launches); primed "
                  "us/query " + " ".join(f"{c} {1e6 * pred[c]:.1f}"
                                         for c in cands), flush=True)
        got = type(outs[0])(*(np.concatenate(xs) for xs in zip(*outs)))
        check(agrees_with(got, results[name, "naive"]),
              f"{name}: auto differs from naive")
        # the cold route (no cost table) on the card and on the CPU
        cold = EngineContext(ctx.targets, index=ctx.index,
                             block_size=ctx.block_size, device=ctx.device)
        U = U_all[name]
        sparse = U[:BATCH].copy()
        sparse[:, 3:] = 0.0
        batches = {"mixed 64": U[:BATCH], "mixed 8": U[:8],
                   "mixed 1": U[:1], "non-negative 64": np.abs(U[:BATCH]),
                   "sparse 64": sparse, "sparse 2": sparse[:2]}
        seen = {}
        for label, b in batches.items():
            card = select_engine(cold, b).name
            cpu = select_engine(cpu_ctxs[name], b).name
            check(card == ("topk_mips" if cpu == "norm" else cpu),
                  f"{name}: the cold route picks {card} on the card and "
                  f"{cpu} on the CPU ({label})")
            seen[label] = card
        print(f"  {name:>18s} auto cold route (card = CPU, norm read as "
              f"topk_mips): {seen}", flush=True)
    launches = {"topk_mips": topk_mips.launches,
                "gather_scores": gather_scores.launches}
    print(f"auto path: picks {sorted(set(picks.values()))}, launches "
          f"{launches}", flush=True)


def ladder_path(servers, U_all, results, dev) -> None:
    """Step 11 of the module docstring."""
    import numpy as np
    from repro_torch.serving.server import (AdmissionPolicy, ServeStats,
                                            TopKServer)
    base = servers[LSH]
    U = U_all[LSH][:BATCH]
    naive = type(results[LSH, "naive"])(
        *(x[:BATCH] for x in results[LSH, "naive"]))
    t0 = time.perf_counter()
    srv = TopKServer(base.model, max_batch=BATCH, device=dev,
                     policy=AdmissionPolicy(degrade_budget=64))
    srv.warmup(K, batch_sizes=(BATCH,), engines=["bta", "norm"],
               budgets=(64,))
    print(f"{LSH} ladder server built and warmed (bta, norm, budget 64) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    st = srv.stats.setdefault("bta", ServeStats())

    def rung_of(before):
        moved = [r for r, n in st.degradations.items()
                 if n > before.get(r, 0)]
        return moved[0] if moved else "full"

    def certified_prefix_ok(res):
        certified = res.upper[:, None] - res.values <= 0
        ok = all(np.allclose(res.values[q, :c], naive.values[q, :c],
                             rtol=RTOL, atol=ATOL)
                 for q, c in enumerate(certified.sum(axis=1)))
        return ok, int((~certified).any(axis=1).sum()), certified

    def shed_ok(res):
        return bool((res.indices == -1).all()
                    and (res.values == -np.inf).all()
                    and (res.upper == np.inf).all())

    forced = [("to_norm", {"bta": 10.0, "norm": 1e-9}, 50.0),
              ("to_budgeted", {"bta": 10.0, "norm": 10.0}, 50.0),
              ("shed", {}, 0.0)]
    for want, ewma, deadline in forced:
        srv._cost_ewma.update(ewma)
        before, unc = dict(st.degradations), st.n_uncertified
        t0 = time.perf_counter()
        res = srv.query(U, K, method="bta", deadline_ms=deadline)
        ms = 1e3 * (time.perf_counter() - t0)
        got = rung_of(before)
        check(got == want, f"ladder: forced {want}, took {got}")
        if want == "to_norm":
            check(agrees_with(res, naive), "ladder: to_norm differs from "
                  "naive")
        elif want == "to_budgeted":
            ok, n_unc, cert = certified_prefix_ok(res)
            check(ok, "ladder: certified slots are not naive's top-K")
            check(st.n_uncertified - unc == n_unc,
                  f"ladder: n_uncertified moved by "
                  f"{st.n_uncertified - unc}, the result holds {n_unc}")
            print(f"  to_budgeted: {n_unc} of {BATCH} queries uncertified, "
                  f"{int(cert.sum())} of {cert.size} slots certified",
                  flush=True)
        else:
            check(shed_ok(res) and st.n_uncertified - unc == BATCH,
                  "ladder: the expired deadline did not shed with "
                  "sentinels")
        print(f"  ladder forced {want}: {ms:.1f} ms for {BATCH} queries",
              flush=True)
    srv.policy.max_inflight = 0
    before = dict(st.degradations)
    res = srv.query(U, K, method="bta")
    check(rung_of(before) == "shed" and shed_ok(res),
          "ladder: max_inflight=0 did not shed")
    srv.policy.max_inflight = AdmissionPolicy().max_inflight
    print("  ladder forced shed by max_inflight=0: sentinels", flush=True)

    # one unforced request, its deadline 2x a topk_mips chunk's cost
    srv._cost_ewma.clear()
    deadline = 2e-3 * base.stats["topk_mips"].p50_us * BATCH
    before = dict(st.degradations)
    t0 = time.perf_counter()
    res = srv.query(U, K, method="bta", deadline_ms=deadline)
    ms = 1e3 * (time.perf_counter() - t0)
    rung = rung_of(before)
    if rung in ("full", "to_norm"):
        check(agrees_with(res, naive), f"ladder: {rung} differs from naive")
    elif rung == "to_budgeted":
        check(certified_prefix_ok(res)[0],
              "ladder: certified slots are not naive's top-K")
    else:
        check(shed_ok(res), "ladder: a shed result holds an answer")
    print(f"ladder: unforced bta request, deadline {deadline:.3f} ms, took "
          f"{rung} in {ms:.3f} ms; degradations {st.degradations}, "
          f"n_uncertified {st.n_uncertified}, req_p50_us "
          f"{st.req_p50_us:.1f}", flush=True)


def streaming_path(servers, U_all, dev):
    """Step 13 of the module docstring. Returns the two rows of the
    kernels line it adds (B1 at ``k = 522``, B4 at this phase's ``bta``
    tail block)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import SegmentedCatalogue, faults, get_engine
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    from repro_torch.serving.server import TopKServer
    t_phase = time.perf_counter()
    base = servers[LSH]
    T_host = base.ctx.targets.cpu().numpy()
    M, r = T_host.shape
    U = U_all[LSH][:BATCH]
    U_dev = torch.from_numpy(U).to(dev)
    rng = np.random.default_rng(SEED + 21)
    t0 = time.perf_counter()
    srv = TopKServer(base.model, max_batch=BATCH, device=dev,
                     delta_capacity=STREAM_DELTA)
    srv.warmup(K, batch_sizes=(BATCH,), engines=["topk_mips"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cat = srv.catalogue
    cpu = SegmentedCatalogue(T_host, delta_capacity=STREAM_DELTA,
                             block_size=srv.block_size, device="cpu")
    print(f"{LSH} streaming server (delta_capacity {STREAM_DELTA}) built and "
          f"warmed for topk_mips in {warm_s:.1f} s", flush=True)

    def new_rows(n):
        """Perturbed copies of catalogue rows: the catalogue's norms."""
        pick = rng.integers(M, size=n)
        noise = rng.standard_normal((n, r)).astype(np.float32)
        return (T_host[pick] + 0.1 * np.abs(T_host[pick]).mean()
                * noise).astype(np.float32)

    def oracle_check(res, label):
        """Values and ids against a dense top-K over the live rows."""
        rows, gids = cat.as_dense()
        s = U_dev @ torch.from_numpy(rows).to(dev).T
        ov, pos = torch.topk(s, K, dim=1)
        og = torch.from_numpy(gids).to(dev)[pos]
        gv = torch.from_numpy(res.values).to(dev)
        gi = torch.from_numpy(res.indices).to(dev).long()
        check(bool(torch.isfinite(gv).all())
              and torch.allclose(gv, ov, rtol=RTOL, atol=ATOL),
              f"streaming {label}: values differ from the dense oracle "
              f"(max abs err {float((gv - ov).abs().max())})")
        check(ids_agree(ov, og, gv, gi),
              f"streaming {label}: ids differ from the dense oracle")

    def cpu_check(label):
        """The first N_CPU_CHECK queries on the card and on the CPU: equal
        values, ids, counts and QueryInfo."""
        eng = get_engine("topk_mips")
        card_res, card_info = cat.query(eng, U[:N_CPU_CHECK], K)
        cpu_res, cpu_info = cpu.query(eng, U[:N_CPU_CHECK], K)
        cv = card_res.values.cpu()
        check(torch.allclose(cv, cpu_res.values, rtol=RTOL, atol=ATOL)
              and ids_agree(cpu_res.values, cpu_res.indices.long(), cv,
                            card_res.indices.cpu().long()),
              f"streaming {label}: the card differs from the CPU")
        for f in ("n_scored", "depth"):
            check(torch.equal(getattr(card_res, f).cpu(),
                              getattr(cpu_res, f)),
                  f"streaming {label}: {f} on the card "
                  f"{getattr(card_res, f).tolist()} != on the CPU "
                  f"{getattr(cpu_res, f).tolist()}")
        check(dataclasses.astuple(card_info) == dataclasses.astuple(cpu_info),
              f"streaming {label}: QueryInfo {card_info} != {cpu_info}")
        return card_info

    rounds = {}

    def serve(label, method="topk_mips", reps=3):
        """``reps`` timed 64-query requests; each result checked."""
        st_lat = []
        for _ in range(reps):
            t = time.perf_counter()
            res = srv.query(U, K, method=method)
            st_lat.append(1e6 * (time.perf_counter() - t) / BATCH)
            oracle_check(res, label)
        rounds[label] = st_lat
        return res

    def both(fn):
        fn(srv)
        fn(cpu)

    def after_build(label, version):
        check(cat.version == version and cpu.version == version,
              f"streaming {label}: versions {cat.version}/{cpu.version}, "
              f"want {version}")
        check(cat.stats.engine_compiles_total == 0,
              f"streaming {label}: {cat.stats.engine_compiles_total} kernel "
              "library loads in compaction builds")

    # q0's top 138 of the base: 38 updated + 100 deleted kill all of them,
    # so at k = 10 its fetch climbs 42 -> 138 -> 522 (dropped 138 > 128)
    top = np.argsort(-(T_host.astype(np.float64) @ U[0].astype(np.float64)),
                     kind="stable")[:138]
    others = np.setdiff1d(rng.choice(M, 64, replace=False), top)[:12]
    upd_gids = np.concatenate([top[:38], others])
    upd_rows = new_rows(len(upd_gids))
    ins_rows = new_rows(200)

    torch.cuda.synchronize()
    topk_mips.launches = gather_scores.launches = 0
    topk_mips.path_launches = dict.fromkeys(topk_mips.path_launches, 0)
    t_main = time.perf_counter()
    serve("pristine")
    info = {"pristine": cpu_check("pristine")}
    both(lambda c: c.add_targets(ins_rows))
    serve("insert 200")
    info["insert 200"] = cpu_check("insert 200")
    both(lambda c: c.update_targets(upd_gids, upd_rows))
    serve("update 50")
    info["update 50"] = cpu_check("update 50")
    both(lambda c: c.delete_targets(top[38:]))
    serve("delete 100")
    info["delete 100"] = cpu_check("delete 100")
    check(info["delete 100"].retried
          and info["delete 100"].overfetch_k == STREAM_LADDER_K,
          f"streaming: the ladder stopped at {info['delete 100']}, not "
          f"{STREAM_LADDER_K}")
    b4_before = gather_scores.launches
    t = time.perf_counter()
    serve("bta chunk", method="bta", reps=1)
    bta_s = time.perf_counter() - t
    bta_launches = gather_scores.launches - b4_before
    check(bta_launches > 0, "streaming: the bta chunk launched no B4")
    bta_ctx = srv.ctx
    # fill the delta: the append after 256 rows compacts synchronously
    n_fill = STREAM_DELTA - cat.delta_occupancy + 1
    rows = new_rows(n_fill)
    both(lambda c: c.add_targets(rows))
    after_build("sync compaction", 1)
    sync_s = cat.stats.last_compaction_s
    serve("after sync compaction")
    info["after sync compaction"] = cpu_check("after sync compaction")
    # a background build with queries during it (default CUDA stream:
    # they serialise behind the build's work and stay exact)
    rows = new_rows(10)
    both(lambda c: c.add_targets(rows))
    cat.compact_async = True
    cat.compact(wait=False)
    during = []
    while len(during) < STREAM_DURING_MAX:
        with cat._lock:
            building = cat._build_thread is not None
        if not building:
            break
        t = time.perf_counter()
        res = srv.query(U, K, method="topk_mips")
        during.append(1e6 * (time.perf_counter() - t) / BATCH)
        oracle_check(res, "during the background build")
    cat.flush()
    cpu.compact()
    after_build("async compaction", 2)
    async_s = cat.stats.last_compaction_s
    serve("after async compaction")
    info["after async compaction"] = cpu_check("after async compaction")
    # a build failed by the fault point, then healed by a retry
    rows = new_rows(5)
    both(lambda c: c.add_targets(rows))
    for c in (cat, cpu):
        with faults.injected("compaction.build", error=RuntimeError):
            try:
                c.compact(wait=True)
            except RuntimeError:
                pass
            else:
                fail("streaming: the injected build failure did not raise")
    check(cat.stats.n_failed_compactions == 1 and cat.l0_chain_len == 1,
          "streaming: the failed build left no retained chain")
    after_build("failed build", 2)
    serve("after the failed build")
    info["after the failed build"] = cpu_check("after the failed build")
    for c in (cat, cpu):
        c.compact(wait=True)
    after_build("retried build", 3)
    retry_s = cat.stats.last_compaction_s
    serve("after the retry")
    info["after the retry"] = cpu_check("after the retry")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    b1 = topk_mips.launches
    b1_paths = dict(topk_mips.path_launches)
    b4 = gather_scores.launches
    check(b1 > 0 and b1_paths["global_carry"] > 0,
          f"streaming: B1 launches {b1} {b1_paths}: the k > 256 path did "
          "not run")

    gpu = gpu_name_and_power()
    for label, lat in rounds.items():
        print(f"  streaming {label:>26s}: {np.median(lat):9.1f} us/query "
              f"(median of {len(lat)}; {gpu})"
              + (f" QueryInfo {info[label]}" if label in info else ""),
              flush=True)
    print(f"streaming: compactions sync {sync_s:.2f} s, async {async_s:.2f} "
          f"s, retried after a failure {retry_s:.2f} s; {len(during)} "
          f"requests during the async build at median "
          f"{np.median(during) if during else float('nan'):.1f} us/query "
          f"(pristine {np.median(rounds['pristine']):.1f}); bta chunk "
          f"{bta_s:.2f} s with {bta_launches} B4 launches; "
          f"mutation_stats {srv.mutation_stats}; launches B1 {b1} "
          f"{b1_paths}, B4 {b4}; main path {main_s:.1f} s ({gpu})",
          flush=True)

    # B1 at the ladder's k = 522 against its plain version, LSHTC-like
    k522 = compare_modes(base.ctx.catalog, U_dev, STREAM_LADDER_K,
                         f"{LSH} k={STREAM_LADDER_K}", timing=True)
    lib_ms = timed_ms_cold(lambda: torch.topk(
        torch.matmul(U_dev, base.ctx.catalog.T_sorted.T), STREAM_LADDER_K),
        10)
    print(f"  {LSH} library torch.topk(torch.matmul(U, T.T), "
          f"{STREAM_LADDER_K}): {lib_ms:.4g} ms", flush=True)
    mode = "two_level_batched"
    rec = k522[mode]
    b1_row = {"name": f"topk_mips[{mode},k={STREAM_LADDER_K}]",
              "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/topk_mips.cu",
              "replaces": REPLACES[mode],
              "launches": b1_paths["global_carry"],
              "max_abs_err": max(v["max_abs_err"] for v in k522.values()),
              **{key: rec[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")},
              "library_ms": lib_ms}
    # B4 at the streaming bta chunk's first tail block
    first_tail = bta_ctx.layout("list_major").prefix_steps(
        bta_ctx.block_size)
    ids = tail_ids(bta_ctx.index, U_dev, bta_ctx.block_size, first_tail)
    b4_rec = compare_gather([("streaming bta tail block", bta_ctx.targets,
                              ids, U_dev, True)])["streaming bta tail block"]
    b4_stream = b4_row("gather_scores[streaming bta]", b4_rec, bta_launches,
                       b4_rec["max_abs_err"])
    print(f"streaming phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return [b1_row, b4_stream]


def lsm_async_path(servers, U_all, dev):
    """Step 14 of the module docstring. Returns the two rows of the
    kernels line it adds (B1 at the coalesced batch's shape, B4 at the
    ``bta`` micro-batch's first tail block)."""
    import dataclasses
    import threading
    import warnings

    import numpy as np
    import torch
    from repro_torch.core import ShardedLsmCatalogue, faults, get_engine
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    from repro_torch.serving.pipeline import AsyncTopKServer
    t_phase = time.perf_counter()
    base = servers[LSH]
    T_host = base.ctx.targets.cpu().numpy()
    M, r = T_host.shape
    U = U_all[LSH][:LSM_BURST]
    n_q = U.shape[0]
    U_dev = torch.from_numpy(U).to(dev)
    rng = np.random.default_rng(SEED + 21)
    t0 = time.perf_counter()
    srv = AsyncTopKServer(base.model, max_batch=BATCH, flush_ms=2.0,
                          method="topk_mips", delta_capacity=STREAM_DELTA,
                          n_shards=LSM_SHARDS, device=dev)
    srv.warmup(K, engines=["topk_mips", "norm"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cat = srv.catalogue
    check(isinstance(cat, ShardedLsmCatalogue)
          and cat.l1_run_capacity == 4 * STREAM_DELTA,
          f"lsm: the server's catalogue is {type(cat).__name__} with runs "
          f"of {getattr(cat, 'l1_run_capacity', None)} rows")
    cpu = ShardedLsmCatalogue(T_host, n_shards=LSM_SHARDS,
                              delta_capacity=STREAM_DELTA,
                              block_size=srv.server.block_size, device="cpu")
    print(f"{LSH} AsyncTopKServer over a ShardedLsmCatalogue ({LSM_SHARDS} "
          f"runs of {cat.l1_run_capacity} rows, delta_capacity "
          f"{STREAM_DELTA}) built and warmed for topk_mips and norm at "
          f"buckets 1..{BATCH} in {warm_s:.1f} s", flush=True)

    def new_rows(n):
        """Perturbed copies of catalogue rows: the catalogue's norms."""
        pick = rng.integers(M, size=n)
        noise = rng.standard_normal((n, r)).astype(np.float32)
        return (T_host[pick] + 0.1 * np.abs(T_host[pick]).mean()
                * noise).astype(np.float32)

    def dense_oracle(state=None):
        """Top-K of every query over the live rows (or ``state``)."""
        rows, gids = cat.as_dense() if state is None else state
        s = U_dev @ torch.from_numpy(rows).to(dev).T
        ov, pos = torch.topk(s, K, dim=1)
        return ov, torch.from_numpy(gids).to(dev)[pos]

    def agrees(res_by_q, oracle):
        """The queries of ``res_by_q`` ({query: result}) whose values and
        ids equal ``oracle``'s."""
        qs = sorted(res_by_q)
        gv = torch.from_numpy(np.stack([res_by_q[q].values[0]
                                        for q in qs])).to(dev)
        gi = torch.from_numpy(np.stack([res_by_q[q].indices[0]
                                        for q in qs])).to(dev).long()
        ov, og = (x[torch.tensor(qs, device=dev)] for x in oracle)
        ok = torch.isclose(gv, ov, rtol=RTOL, atol=ATOL).all(1).tolist()
        return {q for j, q in enumerate(qs) if ok[j] and ids_agree(
            ov[j:j + 1], og[j:j + 1], gv[j:j + 1], gi[j:j + 1])}

    req_lat = []

    def burst(label, race=None):
        """``LSM_CLIENTS`` threads, each submitting its share of the
        queries one at a time (``race``: a thread that mutates meanwhile).
        Returns ({query: result}, seconds)."""
        out, errors = {}, []

        def client(part):
            try:
                for q in part:
                    t = time.perf_counter()
                    res = srv.submit(U[q], K).result(timeout=LSM_WAIT_S)
                    req_lat.append(1e6 * (time.perf_counter() - t))
                    out[int(q)] = res
            except Exception as exc:          # reported below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(part,))
                   for part in np.array_split(np.arange(n_q), LSM_CLIENTS)]
        if race is not None:
            threads.append(threading.Thread(target=race))
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(LSM_WAIT_S)
        dt = time.perf_counter() - t
        check(not any(th.is_alive() for th in threads),
              f"lsm {label}: a client thread hung")
        check(not errors, f"lsm {label}: a request failed: {errors[:1]!r}")
        check(len(out) == n_q, f"lsm {label}: {len(out)} of {n_q} answers")
        return out, dt

    def cpu_check(label):
        """The first N_CPU_CHECK queries on the card and on the CPU: equal
        values, ids, counts and QueryInfo."""
        eng = get_engine("topk_mips")
        card_res, card_info = cat.query(eng, U[:N_CPU_CHECK], K)
        cpu_res, cpu_info = cpu.query(eng, U[:N_CPU_CHECK], K)
        cv = card_res.values.cpu()
        check(torch.allclose(cv, cpu_res.values, rtol=RTOL, atol=ATOL)
              and ids_agree(cpu_res.values, cpu_res.indices.long(), cv,
                            card_res.indices.cpu().long()),
              f"lsm {label}: the card differs from the CPU")
        for f in ("n_scored", "depth"):
            check(torch.equal(getattr(card_res, f).cpu(),
                              getattr(cpu_res, f)),
                  f"lsm {label}: {f} on the card "
                  f"{getattr(card_res, f).tolist()} != on the CPU "
                  f"{getattr(cpu_res, f).tolist()}")
        check(dataclasses.astuple(card_info) == dataclasses.astuple(cpu_info),
              f"lsm {label}: QueryInfo {card_info} != {cpu_info}")
        return card_info

    def round_batches(state):
        """One mutation round's batches, drawn from the card's ``state``
        (equal to the CPU's): inserts; deletes of L1-run rows and of base
        rows in query 0's current top LSM_TOP; updates of L1-run rows."""
        ins = new_rows(LSM_INSERTS)
        rows, gids = state
        snap = cat.snapshot
        n_base = snap.num_rows - snap.n_dead
        l1 = gids[n_base:n_base + cat.l1_rows]    # ladder age order
        half = LSM_DELETES // 2
        s0 = rows[:n_base].astype(np.float64) @ U[0].astype(np.float64)
        top = np.argsort(-s0, kind="stable")[:LSM_TOP]
        if len(l1) < half + LSM_UPDATES:
            # no tier yet: base rows outside query 0's top instead
            l1 = np.setdiff1d(gids[:n_base], gids[top])
        pick = rng.permutation(len(l1))[:half + LSM_UPDATES]
        dels = np.concatenate([l1[pick[:half]], gids[top[:half]]])
        upd = l1[pick[half:]]
        return (ins, dels.astype(np.int64), upd.astype(np.int64),
                new_rows(len(upd)))

    def mutate(c, batches):
        ins, dels, upd, upd_rows = batches
        gids = c.add_targets(ins)
        c.delete_targets(dels)
        c.update_targets(upd, upd_rows)
        return gids

    stats_keys = ("n_l1_folds", "n_failed_l1_folds", "n_compactions",
                  "n_failed_compactions")

    def counted():
        return {key: getattr(cat.stats, key) for key in stats_keys}

    srv.start()
    torch.cuda.synchronize()
    topk_mips.launches = gather_scores.launches = 0
    topk_mips.path_launches = dict.fromkeys(topk_mips.path_launches, 0)
    t_main = time.perf_counter()
    burst_s, infos, fold_tokens = [], {}, 0
    promote_failed_round = bta = race = None
    hits0 = srv.cache.hits
    for rnd in range(LSM_MAX_ROUNDS):
        # -- a burst of single requests, then the hot query's repeats --------
        if rnd == LSM_RACE_ROUND:
            before = cat.as_dense()
            ov, og = dense_oracle(before)
            best = og[:BATCH, 0].cpu().numpy()
            rows_of = {int(g): i for i, g in enumerate(before[1])}
            raced = np.stack([1.5 * before[0][rows_of[int(g)]]
                              for g in best]).astype(np.float32)
            n_done = threading.Event()

            def racer():
                while len(req_lat) < race_from and not n_done.wait(0.001):
                    pass
                srv.add_targets(raced)

            race_from = len(req_lat) + n_q // 3
            res, dt = burst(f"round {rnd} (racing a mutation)", racer)
            n_done.set()
            cpu.add_targets(raced)
            state = cat.as_dense()
            after = dense_oracle(state)
            ok_before = agrees(res, (ov, og))
            ok_after = agrees(res, after)
            check(ok_before | ok_after == set(res),
                  f"lsm: {len(set(res) - (ok_before | ok_after))} results "
                  "of the raced burst equal neither the state before nor "
                  "the state after the mutation")
            race = (len(ok_before - ok_after), len(ok_after - ok_before),
                    len(ok_before & ok_after))
        else:
            res, dt = burst(f"round {rnd}")
            state = cat.as_dense()            # no mutation until the round
            ok = agrees(res, dense_oracle(state))
            check(ok == set(res), f"lsm round {rnd}: {n_q - len(ok)} results "
                  "differ from the dense oracle")
        burst_s.append(dt)
        if rnd == LSM_RACE_ROUND:             # cache the state after it
            srv.submit(U[0], K).result(timeout=LSM_WAIT_S)
        hits, misses = srv.cache.hits, srv.cache.misses
        for _ in range(LSM_HOT_REPEATS):
            hot = srv.submit(U[0], K).result(timeout=LSM_WAIT_S)
        check(srv.cache.hits - hits == LSM_HOT_REPEATS
              and srv.cache.misses == misses,
              f"lsm round {rnd}: the hot query's repeats hit "
              f"{srv.cache.hits - hits} times, missed "
              f"{srv.cache.misses - misses}")
        check(rnd == LSM_RACE_ROUND
              or np.array_equal(hot.indices, res[0].indices),
              f"lsm round {rnd}: the cached answer differs")
        infos[rnd] = cpu_check(f"round {rnd}")
        if cat.stats.n_compactions:
            break                             # the tier has promoted
        # -- a mutation round on both catalogues -----------------------------
        batches = round_batches(state)
        token, was = cat.cache_token(), counted()
        misses = srv.cache.misses
        point = ("compaction.fold_l1" if rnd == LSM_FOLD_FAIL_ROUND
                 else "compaction.promote"
                 if promote_failed_round is None else None)
        for c in (srv, cpu):
            if point is None:
                gids = mutate(c, batches)
            else:
                with faults.injected(point, error=RuntimeError, times=1):
                    gids = mutate(c, batches)
            if c is srv:
                card_gids = gids
        check(np.array_equal(card_gids, gids),
              f"lsm round {rnd}: the card and the CPU gave other gids")
        now = counted()
        for key in stats_keys:
            check(now[key] == getattr(cpu.stats, key),
                  f"lsm round {rnd}: {key} {now[key]} on the card, "
                  f"{getattr(cpu.stats, key)} on the CPU")
        if rnd == LSM_FOLD_FAIL_ROUND:
            check(now["n_failed_l1_folds"] == was["n_failed_l1_folds"] + 1,
                  f"lsm round {rnd}: the injected fold failure did not fire")
        if now["n_failed_compactions"] > was["n_failed_compactions"]:
            promote_failed_round = rnd
            check(cat.l1_rows > 0 or now["n_compactions"],
                  "lsm: a failed promotion moved the tier")
        dv = now["n_compactions"] - was["n_compactions"]
        check(cat.cache_token() == (token[0] + dv, token[1] + 3 + dv),
              f"lsm round {rnd}: cache_token {token} -> "
              f"{cat.cache_token()} with {dv} swaps: a fold moved it")
        fold_tokens += now["n_l1_folds"] > was["n_l1_folds"] and not dv
        srv.submit(U[0], K).result(timeout=LSM_WAIT_S)
        check(srv.cache.misses == misses + 1,
              f"lsm round {rnd}: the hot query hit the cache after a "
              "mutation")
        if rnd == LSM_BTA_ROUND:
            # one 64-query bta micro-batch over the L1 tier, unwarmed, of
            # queries no cache entry of this token holds: the 64 requests
            # arrive together (queued under the pipeline's lock), so they
            # form one batch
            check(cat.l1_rows > 0, "lsm: the bta batch has no L1 tier")
            b4 = gather_scores.launches
            full = srv.pipeline_stats.batch_size_hist.get(BATCH, 0)
            t = time.perf_counter()
            with srv._cond:
                handles = {q: srv.submit(U[q], K, method="bta")
                           for q in range(1, BATCH + 1)}
            out = {q: h.result(timeout=LSM_WAIT_S)
                   for q, h in handles.items()}
            bta_s = time.perf_counter() - t
            check(agrees(out, dense_oracle()) == set(out),
                  "lsm: the bta micro-batch differs from the dense oracle")
            bta = (bta_s, gather_scores.launches - b4, srv.ctx,
                   srv.pipeline_stats.batch_size_hist.get(BATCH, 0) - full)
            check(bta[1] > 0 and bta[3] == 1,
                  f"lsm: the bta micro-batch launched B4 {bta[1]} times in "
                  f"{bta[3]} batches of {BATCH}")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    b1 = topk_mips.launches
    b4 = gather_scores.launches
    check(b1 > 0 and b4 > 0, f"lsm: B1 launched {b1}, B4 {b4} times")
    final = counted()
    ms = srv.mutation_stats
    check(final["n_compactions"] == 1 and final["n_failed_compactions"] == 1
          and final["n_failed_l1_folds"] == 1
          and promote_failed_round is not None and bta is not None
          and race is not None,
          f"lsm: the schedule ran {final}, promotion failed in round "
          f"{promote_failed_round}")
    check(ms["engine_compiles_total"] == 0,
          f"lsm: {ms['engine_compiles_total']} kernel library loads in "
          "builds")
    rows_c, gids_c = cat.as_dense()
    rows_p, gids_p = cpu.as_dense()
    check(np.array_equal(gids_c, gids_p) and np.array_equal(rows_c, rows_p),
          "lsm: the card's and the CPU's live contents differ")

    # the synchronizing calls of one topk_mips dispatch, as the
    # dispatcher makes it
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cat.query(get_engine("topk_mips"), U[:BATCH], K)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    # the same queries through the synchronous server, 64 a chunk
    sync_us = []
    for _ in range(3):
        t = time.perf_counter()
        res = srv.server.query(U, K, method="topk_mips")
        sync_us.append(1e6 * (time.perf_counter() - t) / n_q)
    ov, og = dense_oracle()
    check(torch.allclose(torch.from_numpy(res.values).to(dev), ov,
                         rtol=RTOL, atol=ATOL),
          "lsm: the synchronous server differs from the dense oracle")

    gpu = gpu_name_and_power()
    st = srv.stats["topk_mips"]
    ps = srv.pipeline_stats
    folds = final["n_l1_folds"]
    async_us = [1e6 * s / n_q for s in burst_s]
    print(f"lsm async: {len(burst_s)} bursts of {n_q} requests "
          f"({LSM_CLIENTS} client threads), {ps.n_requests} requests in "
          f"{ps.n_batches} micro-batches, mean batch "
          f"{ps.mean_batch_size:.2f}, histogram {ps.batch_size_hist}; "
          f"req_p50_us {np.percentile(req_lat, 50):.1f} req_p99_us "
          f"{np.percentile(req_lat, 99):.1f} (client side, all "
          f"{len(req_lat)}; ServeStats ring {st.req_p50_us:.1f} / "
          f"{st.req_p99_us:.1f}); burst us/query median "
          f"{np.median(async_us):.1f} ({gpu})", flush=True)
    print(f"lsm async: cache {srv.cache.hits - hits0} hits / "
          f"{srv.cache.misses} misses, {srv.cache.n_invalidations} "
          f"invalidations; folds {folds} ({ms['l1_fold_s_total'] / folds:.4f}"
          f" s a fold, {ms['n_l1_fold_retries']} retried after the failed "
          f"one in round {LSM_FOLD_FAIL_ROUND}), cache_token unmoved across "
          f"the folds of {fold_tokens} rounds; promotion failed in round "
          f"{promote_failed_round}, then rebuilt in "
          f"{ms['last_compaction_s']:.2f} s: {final['n_compactions']} full "
          f"rebuild against {folds} folds; raced burst: {race[0]} results "
          f"of the state before, {race[1]} after, {race[2]} of both; bta "
          f"micro-batch {bta[0]:.2f} s with {bta[1]} B4 launches; launches "
          f"B1 {b1} {dict(topk_mips.path_launches)}, B4 {b4}; "
          f"engine_compiles_total {ms['engine_compiles_total']}; "
          f"{len(syncs)} synchronizing calls in one topk_mips dispatch"
          + (f" (at {', '.join(syncs)})" if syncs else "")
          + f"; sync TopKServer.query {np.median(sync_us):.1f} us/query "
          f"(median of 3, 64 a chunk); main path {main_s:.1f} s ({gpu})",
          flush=True)
    print(f"  lsm QueryInfo of the first {N_CPU_CHECK} queries by round: "
          + "; ".join(f"{rnd}: {i.overfetch_k}/{i.delta_scored}/"
                      f"{i.n_segments}/v{i.version}"
                      for rnd, i in infos.items()), flush=True)

    # B1 at the coalesced batch's shape and the tombstoned first fetch
    Ub = U_dev[:LSM_B1_BATCH].contiguous()
    b1_rec = compare_modes(cat.snapshot.ctx.catalog, Ub, LSM_B1_K,
                           f"lsm B={LSM_B1_BATCH} k={LSM_B1_K}", timing=True,
                           modes=("two_level_batched",))["two_level_batched"]
    lib_ms = timed_ms_cold(lambda: torch.topk(torch.matmul(
        Ub, cat.snapshot.ctx.catalog.T_sorted.T), LSM_B1_K), 10)
    b1_row = {"name": f"topk_mips[lsm async,B={LSM_B1_BATCH},k={LSM_B1_K}]",
              "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/topk_mips.cu",
              "replaces": REPLACES["two_level_batched"], "launches": b1,
              "max_abs_err": b1_rec["max_abs_err"],
              **{key: b1_rec[key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")},
              "library_ms": lib_ms}
    # B4 at the bta micro-batch's first tail block
    bta_ctx = bta[2]
    first_tail = bta_ctx.layout("list_major").prefix_steps(
        bta_ctx.block_size)
    U_bta = U_dev[1:BATCH + 1].contiguous()
    ids = tail_ids(bta_ctx.index, U_bta, bta_ctx.block_size, first_tail)
    b4_rec = compare_gather([("lsm bta tail block", bta_ctx.targets, ids,
                              U_bta, True)])["lsm bta tail block"]
    b4_lsm = b4_row("gather_scores[lsm bta]", b4_rec, b4,
                    b4_rec["max_abs_err"])
    srv.close()
    print(f"lsm async phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return [b1_row, b4_lsm]


def oracle_path(dev) -> None:
    """Step 12 of the module docstring."""
    import numpy as np
    import torch
    from repro_torch.configs.seplr_paper import CF_DATASETS
    from repro_torch.core.engines import EngineContext, get_engine
    from repro_torch.core.seplr import random_model
    from repro_torch.core.toy import TOY_BEST_ITEM, TOY_T, TOY_U
    ctx = EngineContext(TOY_T, device=dev)
    for name, scored, depth in (("fagin", 9, 5), ("ta", 5, 2),
                                ("partial", 5, 2)):
        res = get_engine(name).run(ctx, TOY_U, 1)
        got = (int(res.indices[0, 0]), int(res.n_scored[0]),
               int(res.depth[0]))
        check(res.values.device.type == ctx.device.type
              and got == (TOY_BEST_ITEM, scored, depth),
              f"Table 1: {name} gives (best, scored, depth) {got}, the "
              f"paper {(TOY_BEST_ITEM, scored, depth)}")
    print("Table 1 through a card context: fagin depth 5 scoring 9, ta 2 "
          "rounds scoring 5, partial touching 5; best item 5", flush=True)
    cfg = next(c for c in CF_DATASETS if c.name == ORACLE_CATALOGUE)
    rng = np.random.default_rng(SEED)
    model = random_model(rng, cfg.num_targets, cfg.rank, cfg.distribution,
                         cfg.sparsity, name=cfg.name, device=dev)
    U = queries(rng, N_ORACLE_QUERIES, cfg.rank, cfg.distribution)
    ctx = EngineContext(model.targets, device=dev)
    res, secs = {}, {}
    for name in ("ta", "fagin", "partial"):
        t0 = time.perf_counter()
        out = get_engine(name).run(ctx, U, K)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        res[name] = type(out)(*(x.cpu().numpy() for x in out))
    for name in ("fagin", "partial"):
        check(agrees_with(res[name], res["ta"]),
              f"{cfg.name}: {name} differs from ta")
    check(np.array_equal(res["partial"].n_scored, res["ta"].n_scored),
          f"{cfg.name}: partial touches {res['partial'].n_scored.tolist()}, "
          f"ta scores {res['ta'].n_scored.tolist()}")
    print(f"{cfg.name} ({cfg.num_targets} x {cfg.rank}), "
          f"{N_ORACLE_QUERIES} queries: host s " + ", ".join(
              f"{n} {t:.2f}" for n, t in secs.items())
          + "; n_scored mean " + ", ".join(
              f"{n} {res[n].n_scored.mean():.1f}" for n in res)
          + "; partial's n_scored equals ta's query for query", flush=True)


def zero_counters() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.fm_interaction import fm_interaction
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    for c in (topk_mips, gather_scores, embedding_bag, fm_interaction):
        c.launches = 0


def read_counters() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.fm_interaction import fm_interaction
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    return {c.__name__: c.launches for c in (topk_mips, gather_scores,
                                             embedding_bag, fm_interaction)}


def normwise(got, want) -> float:
    """``||got - want|| / ||want||`` in fp32 over any shapes and devices."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm())


def grads(loss, params, batch):
    """``(loss, {path key: gradient})`` of every parameter leaf, where
    ``loss(params, batch)`` returns ``(value, metrics)``."""
    import torch
    from repro_torch.train.tree import (path_key, tree_flatten_with_path,
                                        tree_unflatten)
    flat = tree_flatten_with_path(params)
    leaves = [x.detach().requires_grad_() for _, x in flat]
    value, _ = loss(tree_unflatten(params, leaves), batch)
    return value.detach(), dict(zip((path_key(p) for p, _ in flat),
                                    torch.autograd.grad(value, leaves)))


def lm_topk_agree(got, want, dtype: str, k: int) -> bool:
    """Top-(k+1) ``(values, ids)`` of two runs: the first k values within
    ``LM_TOL`` of the largest, ids equal where ``want``'s logit stands clear
    of its neighbours (the (k+1)-th one included) by more than that."""
    gv, gi = (t.cpu() for t in got)
    wv, wi = (t.cpu() for t in want)
    tol = LM_TOL[dtype] * float(wv.abs().max())
    if float((gv[:, :k] - wv[:, :k]).abs().max()) > tol:
        return False
    gaps = (wv[:, 1:] - wv[:, :-1]).abs()                    # [B, k]
    before = gaps.new_full(gaps.shape, float("inf"))
    before[:, 1:] = gaps[:, :-1]
    clear = (gaps > tol) & (before > tol)
    return bool((gi[:, :k][clear] == wi[:, :k][clear]).all())


def lm_head_witness(hidden, unembed, vals, ids) -> int:
    """Holds a top-K head's ``(vals, ids)`` against a witness that shares
    no code with it: float64 logits ``hidden @ unembed`` and ``torch.topk``.
    ``rnd``, row by row, bounds the rounding of the head's fp32 product
    (``D * 2**-24 * max_v |hidden| @ |unembed|``). Each value must lie
    within ``rnd`` of its id's float64 logit, each id's logit within
    ``2 * rnd`` of the witness's at its rank, and the ids must equal the
    witness's wherever the rank's logit stands clear of both neighbours
    (the (K+1)-th one included) by more than ``2 * rnd``, where rounding
    cannot reorder them. Returns the number of ranks compared id for id;
    raises on a disagreement."""
    import torch
    K = ids.shape[1]
    h, U = hidden.double(), unembed.double()
    logits = h @ U
    rnd = h.shape[-1] * 2.0 ** -24 * (h.abs() @ U.abs()).amax(
        dim=-1, keepdim=True)
    del U
    wv, wi = torch.topk(logits, K + 1, dim=-1)
    got = logits.gather(1, ids.long())
    check(bool(((vals.double() - got).abs() <= rnd).all()),
          "head values differ from their ids' float64 logits by more than "
          "the fp32 rounding")
    check(bool(((got - wv[:, :K]).abs() <= 2 * rnd).all()),
          "a head id's float64 logit is not the witness's at its rank")
    gaps = wv[:, :-1] - wv[:, 1:]                            # [B, K]
    before = torch.full_like(gaps, float("inf"))
    before[:, 1:] = gaps[:, :-1]
    clear = (gaps > 2 * rnd) & (before > 2 * rnd)
    check(bool((ids.long()[clear] == wi[:, :K][clear]).all()),
          "head ids differ from torch.topk of the float64 logits")
    return int(clear.sum())


def lm_decode(params, cfg, prompt, steps: int, top_k: int, timed=None,
              moe_aux=None):
    """``prefill`` then ``steps`` greedy ``serve_step``s from the top-K
    head. Returns ``(cache, fed tokens, [(values, ids)] of the prefill head
    and each step)``; with ``timed`` a list, appends each step's host ms
    (after a synchronize); with ``moe_aux`` a list, appends the MoE layers'
    aux dicts of the prefill, then of each step (one list each)."""
    import torch
    from repro_torch.models import transformer as tf
    B, P = prompt.shape
    dt = cfg.compute_dtype

    def aux():
        if moe_aux is None:
            return None
        moe_aux.append([])
        return moe_aux[-1]

    h, pre = tf.prefill(params, prompt, cfg, cache_dtype=dt, moe_aux=aux())
    cache = tf.init_kv_cache(cfg, B, P + steps, dtype=dt,
                             device=prompt.device)
    for key in ("k", "v"):
        cache[key][:, :, :P] = pre[key]
    del pre
    outs = [tf.topk_logits(h, params["unembed"], top_k)]
    fed = []
    for step in range(steps):
        fed.append(outs[-1][1][:, :1])
        if timed is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out, cache = tf.serve_step(params, cache, fed[-1], P + step, cfg,
                                   top_k=top_k, moe_aux=aux())
        if timed is not None:
            torch.cuda.synchronize()
            timed.append(1e3 * (time.perf_counter() - t0))
        outs.append(out)
    return cache, fed, outs


def expert_sets(aux_list, B: int, S: int):
    """``[L, B, S, k]`` sorted expert ids of one call's MoE layers."""
    import torch
    return torch.stack([a["expert_ids"].reshape(B, S, -1).sort(-1).values
                        .cpu() for a in aux_list])


def first_flips(aux_a, aux_b, B: int, S: int, dtype: str,
                rows=None) -> tuple:
    """Two runs' routing of the same ``[B, S]`` tokens, MoE layer by layer:
    per row, the first position whose expert set differs in any layer
    (``S`` where none). A flip changes its token's hidden state and,
    through attention, every later position's, so only the first is held
    to a rule: at fp32 none may occur; at bf16 it must be a near-tie in
    the first layer where it occurs, ``aux_b``'s k-th and (k+1)-th router
    logits of the token within ``LM_MOE_TIE`` of its largest magnitude
    and within twice the largest difference between the two runs' logits
    of the token (what the difference in the router's input can
    reorder). ``rows`` limits the rule to those rows. Returns the first
    positions and, for each checked flip, its gap over the largest
    magnitude."""
    import torch
    sets_a, sets_b = expert_sets(aux_a, B, S), expert_sets(aux_b, B, S)
    k = sets_a.shape[-1]
    diff = (sets_a != sets_b).any(-1)                          # [L, B, S]
    first = torch.where(diff.any(0), torch.arange(S), S).amin(1).tolist()
    gaps = []
    for b, f in enumerate(first):
        if f == S or (rows is not None and b not in rows):
            continue
        check(dtype == "bfloat16", f"{dtype}: row {b} routed otherwise at "
              f"position {f}")
        layer = int(diff[:, b, f].nonzero()[0])
        la, lb = (aux[layer]["router_logits"].reshape(B, S, -1)[b, f]
                  .double().cpu() for aux in (aux_a, aux_b))
        top = lb.sort(descending=True).values
        gap, scale = float(top[k - 1] - top[k]), float(lb.abs().max())
        check(gap <= LM_MOE_TIE * scale
              and gap <= 2 * float((la - lb).abs().max()),
              f"row {b}'s first routing flip (position {f}, layer {layer}) "
              f"is no near-tie: a gap of {gap:.4g} against the largest "
              f"logit magnitude {scale:.4g}")
        gaps.append(gap / scale)
    return first, gaps


def drop_rates(aux_list) -> list:
    return [float(a["drop_rate"]) for a in aux_list]


def moe_capacity(cfg, n_tokens: int) -> int:
    from repro_torch.models.moe import expert_capacity
    return expert_capacity(n_tokens, cfg.moe_top_k, cfg.capacity_factor,
                           cfg.n_experts)


def lm_bounds(cfg, B: int, P: int, T: int, prefill_kept=None,
              step_kept=None) -> dict:
    """The least times of a decode step (B tokens at a context of P + T)
    and of the prefill (B x P tokens): bytes each input once over the HBM
    rate, against the operations this run's data needs over the peak rate
    of their type. A MoE layer reads every expert's bf16 weights each step
    (the capacity buffer covers them all); its expert GEMMs count the
    routed assignments the layer kept (``*_kept``: each layer's share, 1
    - its drop rate; all by default), not the padded ``[E, capacity]``
    buffer. The prefill's attention counts the causal half: position p
    attends to p + 1 keys."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    attn = D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D
    if cfg.moe:
        E, F = cfg.n_experts, cfg.moe_d_ff
        ffn, router, row = 3 * E * D * F, D * E, 3 * D * F
    else:
        ffn, router, row = 3 * D * cfg.d_ff, 0, 0
    proj = L * (attn + ffn)
    cache_bytes = 2 * L * B * (P + T) * cfg.kv_dim * 2
    step_bytes = 2 * proj + 4 * L * router + 4 * (2 * L * D + D) \
        + 4 * D * V + cache_bytes + 4 * B * D

    def gemm_ops(n_tokens, kept):
        """bf16 projection operations, fp32 router operations."""
        if not cfg.moe:
            return 2 * n_tokens * proj, 0
        rows = n_tokens * cfg.moe_top_k * sum(kept or [1.0] * L)
        return (2 * n_tokens * L * attn + 2 * rows * row,
                2 * n_tokens * L * router)

    bf16_ops, fp32_ops = gemm_ops(B, step_kept)
    step_ops_ms = 1e3 * (bf16_ops / BF16_FLOPS_PER_S
                         + (fp32_ops + 2 * B * D * V) / FP32_FLOPS_PER_S)
    bf16_ops, fp32_ops = gemm_ops(B * P, prefill_kept)
    causal = 4 * L * B * cfg.n_heads * cfg.head_dim * P * (P + 1) // 2
    prefill_ops_ms = 1e3 * ((bf16_ops + causal) / BF16_FLOPS_PER_S
                            + fp32_ops / FP32_FLOPS_PER_S)
    return {"step_bytes": step_bytes,
            "step_bound_ms": max(1e3 * step_bytes / HBM_BYTES_PER_S,
                                 step_ops_ms),
            "prefill_bound_ms": max(prefill_ops_ms,
                                    1e3 * 2 * proj / HBM_BYTES_PER_S)}


def lm_path(dev, arch: str, n_params: int) -> None:
    """The LM serving phase of ``arch`` at full width and depth: step 16
    of the module docstring for gemma-2b, step 17's (a) and (b) for
    olmoe-1b-7b, whose (c) it runs on its 2-layer cut."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import count_params

    t_phase = time.perf_counter()
    gpu = gpu_name_and_power()
    cfg = get_arch(arch).make_config()
    check(cfg.param_count() == n_params,
          f"{arch}: param_count {cfg.param_count()} != {n_params}")
    B, P, T, K, V = LM_BATCH, LM_PROMPT, LM_STEPS, LM_TOP_K, cfg.vocab_size
    prompt = torch.from_numpy(
        next(lm_batches(SEED, V, B, P))["tokens"]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()

    # -- the weights, drawn on the card; the layer stack cast to bf16 once ---
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    served = tf.serving_params(params, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(count_params(params) == n_params,
          f"{arch}: {count_params(params)} parameters drawn")

    # -- prefill, timed twice (the first call sets up cuBLAS) ----------------
    prefill_ms, prefill_aux = [], []
    for _ in range(2):
        prefill_aux.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.prefill(served, prompt, cfg, moe_aux=prefill_aux)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))

    # -- the served path: prefill, then T greedy top-K decode steps ----------
    step_ms, steps_aux = [], []
    cache, fed, outs = lm_decode(served, cfg, prompt, T, K, timed=step_ms,
                                 moe_aux=steps_aux)
    torch.cuda.synchronize()
    launches = read_counters()
    check(not any(launches.values()),
          f"the {arch} path launched a kernel {launches}: its head is the "
          "plain fp32 product and stable top-K, as the reference's")
    for vals, ids in outs:
        check(vals.shape == (B, K) and bool(torch.isfinite(vals).all())
              and bool((vals[:, :-1] >= vals[:, 1:]).all()),
              f"{arch}: top-{K} values not finite and descending")
        check(ids.dtype == torch.int32 and bool(((ids >= 0) & (ids < V))
                                                .all()),
              f"{arch}: top-{K} ids outside [0, {V})")

    # the last step's hidden state, for the head's witness below (the step
    # rerun: it writes the same cache row)
    h_last = tf.decode_hidden(served, cache, fed[-1], P + T - 1, cfg)
    check(bool(torch.isfinite(h_last.float()).all()),
          f"{arch}: the decode path's hidden state is not finite")

    # where a step's time goes: the last step again (it rewrites the same
    # cache row)
    prof = profile_call(f"one {arch} decode step", lambda: tf.serve_step(
        served, cache, fed[-1], P + T - 1, cfg, top_k=K), {})

    # the decode path's last hidden state against forward over the tokens
    moe_check = {}
    if cfg.moe:
        # drop-free (an expert's capacity is every token): a step's
        # capacity is not the forward's, and capacity decides what drops
        del cache
        check_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        steps = LM_MOE_CHECK_STEPS
        c_cache, c_fed, _ = lm_decode(served, check_cfg, prompt, steps, K)
        dec_aux, fwd_aux = [], []
        h_dec = tf.decode_hidden(served, c_cache, c_fed[-1], P + steps - 1,
                                 check_cfg, moe_aux=dec_aux)
        del c_cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h_fwd = tf.forward(served, torch.cat([prompt] + c_fed, dim=1),
                           check_cfg, moe_aux=fwd_aux)[0]
        torch.cuda.synchronize()
        forward_ms = 1e3 * (time.perf_counter() - t0)
        bf16_err = normwise(h_dec, h_fwd[:, -1])
        differ = (expert_sets(dec_aux, B, 1)[:, :, 0]
                  != expert_sets(fwd_aux, B, P + steps)[:, :, -1]
                  ).any(-1)                                  # [L, B]
        moe_check = {"bf16_set_flips": int(differ.sum()),
                     "bf16_pairs": int(differ.numel()),
                     "forward_drop_free": max(drop_rates(fwd_aux)) == 0.0}
        check(moe_check["forward_drop_free"],
              f"{arch}: the drop-free forward dropped tokens")
        check(moe_check["bf16_set_flips"]
              <= LM_MOE_FLIP_SHARE * moe_check["bf16_pairs"],
              f"{arch}: decode vs forward, bf16: {differ.sum()} of "
              f"{differ.numel()} (layer, row) expert sets differ")
        bf16_tol = LM_MOE_TOL_BF16
    else:
        check_cfg = cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h_fwd = tf.forward(served, torch.cat([prompt] + fed, dim=1), cfg)[0]
        torch.cuda.synchronize()
        forward_ms = 1e3 * (time.perf_counter() - t0)
        bf16_err = normwise(h_last, h_fwd[:, -1])
        bf16_tol = LM_TOL["bfloat16"]
    check(bf16_err <= bf16_tol,
          f"{arch}: decode path vs forward, bf16: {bf16_err:.3g} > "
          f"{bf16_tol}")
    peak_bytes = torch.cuda.max_memory_allocated()
    # (after the peak is read: the witness holds a float64 unembed)
    head_ranks = lm_head_witness(h_last, served["unembed"], *outs[-1])
    check(head_ranks > 0, f"{arch}: no rank of the head stood clear")
    del served, h_fwd
    if not cfg.moe:
        del cache

    # the same at fp32 (the fp32 parameters as drawn), shorter
    cfg32 = dataclasses.replace(check_cfg, compute_dtype=torch.float32)
    prompt32 = prompt[:LM_FP32_BATCH, :LM_FP32_PROMPT]
    P32 = prompt32.shape[1] + LM_FP32_STEPS
    cache, fed32, _ = lm_decode(params, cfg32, prompt32, LM_FP32_STEPS, K)
    dec_aux, fwd_aux = [], []
    h_dec = tf.decode_hidden(params, cache, fed32[-1], P32 - 1, cfg32,
                             moe_aux=dec_aux)
    h_fwd = tf.forward(params, torch.cat([prompt32] + fed32, dim=1), cfg32,
                       moe_aux=fwd_aux)[0]
    fp32_err = normwise(h_dec, h_fwd[:, -1])
    check(fp32_err <= LM_TOL["float32"],
          f"{arch}: decode path vs forward, fp32: {fp32_err:.3g} > "
          f"{LM_TOL['float32']}")
    if cfg.moe:
        check(bool((expert_sets(dec_aux, LM_FP32_BATCH, 1)[:, :, 0]
                    == expert_sets(fwd_aux, LM_FP32_BATCH, P32)[:, :, -1])
                   .all()) and max(drop_rates(fwd_aux)) == 0.0,
              f"{arch}: decode vs forward, fp32: the experts differ")
    del params, cache, h_fwd
    torch.cuda.empty_cache()

    # -- a 2-layer cut across the card and the CPU (and, MoE, the mesh) ------
    t0 = time.perf_counter()
    cross, cut_flips, cut_gaps, mesh_rec = lm_cut(dev, cfg, prompt)
    cross_s = time.perf_counter() - t0

    # -- the numbers ----------------------------------------------------------
    kept = {}
    if cfg.moe:
        step_drops = np.array([drop_rates(a) for a in steps_aux[1:]])
        kept = {"prefill_kept": [1 - d for d in drop_rates(prefill_aux)],
                "step_kept": (1 - step_drops.mean(0)).tolist()}
    bounds = lm_bounds(cfg, B, P, T, **kept)
    med = float(np.median(step_ms))
    rec = {"arch": arch, "params": n_params, "batch": B, "prompt": P,
           "steps": T, "top_k": K, "init_s": init_s,
           "prefill_ms": prefill_ms[1], "prefill_first_ms": prefill_ms[0],
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "tokens_per_s": B / (med / 1e3),
           **bounds, "forward_ms": forward_ms, "peak_bytes": peak_bytes,
           "head_ranks_compared": head_ranks,
           "decode_vs_forward": {"bfloat16": bf16_err, "float32": fp32_err},
           "card_vs_cpu": cross, "card_vs_cpu_s": cross_s,
           "launches": launches, "phase_s": time.perf_counter() - t_phase,
           "card": gpu}
    if prof is not None:
        rec["step_profile"] = {key: prof[key] for key in ("wall_us",
                                                          "busy_us",
                                                          "launches")}
    if cfg.moe:
        rec.update(moe_check)
        rec["prefill_capacity"] = moe_capacity(cfg, B * P)
        rec["step_capacity"] = moe_capacity(cfg, B)
        rec["prefill_drop_rate"] = drop_rates(prefill_aux)
        rec["step_drop_rate_mean_by_layer"] = step_drops.mean(0).tolist()
        rec["step_drop_rate_max"] = float(step_drops.max())
        rec["cut_first_flips"] = cut_flips
        rec["cut_flip_gaps"] = cut_gaps
        rec["mesh"] = mesh_rec
    moe_note = ""
    if cfg.moe:
        moe_note = (f"; drop rate prefill (capacity "
                    f"{rec['prefill_capacity']}) mean "
                    f"{np.mean(rec['prefill_drop_rate']):.4f} by layer "
                    f"{[round(d, 4) for d in rec['prefill_drop_rate']]}, "
                    f"steps (capacity {rec['step_capacity']}) mean "
                    f"{step_drops.mean():.5f} max "
                    f"{rec['step_drop_rate_max']:.4f}; cut, bf16: first "
                    f"flips in the prefill at {cut_flips['bfloat16']} of "
                    f"{LM_CPU_PROMPT}, the flips' gaps over the largest logit "
                    f"{[round(g, 5) for g in cut_gaps]}; decode vs drop-free "
                    f"forward, bf16: {moe_check['bf16_set_flips']} of "
                    f"{moe_check['bf16_pairs']} (layer, row) expert sets "
                    f"differ")
    print(f"lm {arch} ({gpu}): {B} prompts x {P} tokens, prefill "
          f"{prefill_ms[1]:.2f} ms (first call {prefill_ms[0]:.2f}; bound "
          f"{bounds['prefill_bound_ms']:.2f}); decode step median {med:.3f} "
          f"ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{rec['tokens_per_s']:.1f} tokens/s, byte bound "
          f"{bounds['step_bound_ms']:.3f} ms "
          f"({bounds['step_bytes'] / 1e9:.3f} GB a step); forward "
          f"{forward_ms:.2f} ms; peak memory {peak_bytes / 2**30:.2f} GiB; "
          f"head vs float64 witness: {head_ranks} of {B * K} ranks "
          f"compared id for id; decode vs forward bf16 {bf16_err:.3g}, "
          f"fp32 {fp32_err:.3g}; {LM_CPU_LAYERS}-layer card vs CPU {cross} "
          f"in {cross_s:.1f} s{moe_note}; phase {rec['phase_s']:.1f} s",
          flush=True)
    print("lm: " + json.dumps(rec), flush=True)


def lm_cut(dev, cfg, prompt):
    """A 2-layer cut of ``cfg``, drawn once on the CPU and copied to the
    card: ``prefill`` and ``serve_step`` on the card against the CPU at
    fp32 and bf16. The prefills are compared (hidden state and caches),
    then the steps, each side's from its own prefill cache. A MoE cut at
    bf16, where near-tied experts may flip between the two GEMM libraries'
    roundings (``first_flips``: each row's first flip a near-tie, at least
    ``LM_MOE_CUT_SHARE`` of the positions before the flips), compares each
    row's prefill cache up to its first flip and its last hidden state
    only in a row without one; its steps start from one state, the CPU's
    prefill cache on both sides, and compare the rows whose step routing
    agrees, each step flip a near-tie too. At fp32 no token may flip. Then
    it runs the mesh checks (``moe_mesh_path``). Returns ``(worst normwise
    error by dtype, each row's first flip in the prefill by dtype (the
    prompt's length where none), the flips' gaps over the largest logit
    magnitude, the mesh record or None)``."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    cfg2 = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS)
    on_cpu = tf.init_params(cfg2, torch.Generator().manual_seed(SEED), "cpu")
    on_card = tree_to(on_cpu, dev)
    rows = LM_MOE_CPU_BATCH if cfg.moe else LM_CPU_BATCH
    P, steps, K = LM_CPU_PROMPT, LM_CPU_STEPS, LM_TOP_K
    cut = prompt[:rows, :P]
    cross, flipped, gaps = {}, {}, []
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg2, compute_dtype=getattr(torch, dtype))
        card, cpu = (tf.serving_params(p, c) for p in (on_card, on_cpu))
        aux_card, aux_cpu = [], []
        h_card, pre_card = tf.prefill(card, cut, c,
                                      cache_dtype=c.compute_dtype,
                                      moe_aux=aux_card)
        h_cpu, pre_cpu = tf.prefill(cpu, cut.cpu(), c,
                                    cache_dtype=c.compute_dtype,
                                    moe_aux=aux_cpu)
        first = [P] * rows
        if c.moe:
            first, g = first_flips(aux_card, aux_cpu, rows, P, dtype)
            gaps += g
            check(sum(first) >= LM_MOE_CUT_SHARE * rows * P,
                  f"{cfg.name} x{LM_CPU_LAYERS}, {dtype}: card vs CPU, "
                  f"first routing flips at {first} of {P}")
        clean = [b for b, f in enumerate(first) if f == P]
        flipped[dtype] = first
        errs = [normwise(*(torch.cat([pre[key][:, b, :f].cpu().float()
                                      for b, f in enumerate(first)], dim=1)
                           for pre in (pre_card, pre_cpu)))
                for key in ("k", "v")]
        if clean:
            errs.append(normwise(h_card[clean], h_cpu[clean]))
        caches = []
        for pre, dv in zip((pre_cpu if c.moe else pre_card, pre_cpu),
                           (dev, "cpu")):
            cache = tf.init_kv_cache(c, rows, P + steps,
                                     dtype=c.compute_dtype, device=dv)
            for key in ("k", "v"):
                cache[key][:, :, :P] = pre[key]
            caches.append(cache)
        same = list(range(rows))
        h, U = (h_cpu, cpu["unembed"]) if c.moe else (h_card, card["unembed"])
        tok = tf.topk_logits(h, U, K)[1][:, :1].to(dev)
        for step in range(steps):
            pos = P + step
            sa, sb = [], []
            got, caches[0] = tf.serve_step(card, caches[0], tok, pos, c,
                                           top_k=K + 1, moe_aux=sa)
            want, caches[1] = tf.serve_step(cpu, caches[1], tok.cpu(), pos,
                                            c, top_k=K + 1, moe_aux=sb)
            if c.moe:
                moved, g = first_flips(sa, sb, rows, 1, dtype, rows=same)
                gaps += g
                same = [b for b in same if moved[b] == 1]
            check(same and lm_topk_agree(
                tuple(t[same] for t in got), tuple(t[same] for t in want),
                dtype, K),
                  f"{cfg.name} x{LM_CPU_LAYERS}, {dtype}: serve_step step "
                  f"{step} on the card differs from the CPU (rows {same})")
            tok = got[1][:, :1]
        errs += [normwise(caches[0][key][:, same], caches[1][key][:, same])
                 for key in ("k", "v")]
        cross[dtype] = max(errs)
        check(cross[dtype] <= LM_TOL[dtype],
              f"{cfg.name} x{LM_CPU_LAYERS}, {dtype}: card vs CPU "
              f"{errs} > {LM_TOL[dtype]}")
    mesh_rec = moe_mesh_path(dev, cfg2, on_cpu, on_card, prompt) \
        if cfg.moe else None
    return cross, flipped, gaps, mesh_rec


def moe_mesh_path(dev, cfg2, on_cpu, on_card, prompt) -> dict:
    """Step 17(c): the 2-layer MoE cut over 4 logical shards of the card
    as ``("data", "model")`` meshes of ``(1, 4)`` and ``(2, 2)`` — EP
    (``moe_ffn_ep``) and the vocab-sharded head — against the same calls
    on a CPU mesh at fp32; the sharded head id for id against the
    unsharded one on the same hidden state; an EP step's ms beside a
    non-EP step's (bf16, 16 rows)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.moe import ep_available
    c = dataclasses.replace(cfg2, compute_dtype=torch.float32)
    rows, P, steps, K = LM_MOE_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_STEPS, \
        LM_TOP_K
    cut = prompt[:rows, :P]
    rec = {}
    for shape in LM_MESHES:
        name = "x".join(map(str, shape))
        mc = make_mesh(shape, ("data", "model"), [dev] * SHARDS)
        mh = make_mesh(shape, ("data", "model"), ["cpu"] * SHARDS)
        check(ep_available(c.n_experts, tf.DEFAULT_RULES, mc),
              f"{name}: the mesh does not take the EP path")
        out = {}
        for side, p, mesh, x in (("card", on_card, mc, cut),
                                 ("cpu", on_cpu, mh, cut.cpu())):
            h, pre = tf.prefill(p, x, c, cache_dtype=torch.float32,
                                mesh=mesh)
            cache = tf.init_kv_cache(c, rows, P + steps, dtype=torch.float32,
                                     device=x.device)
            for key in ("k", "v"):
                cache[key][:, :, :P] = pre[key]
            out[side] = {"h": h, "pre": pre, "cache": cache, "mesh": mesh,
                         "p": p}
        errs = [normwise(out["card"]["h"], out["cpu"]["h"])] + [
            normwise(out["card"]["pre"][key], out["cpu"]["pre"][key])
            for key in ("k", "v")]
        # the sharded head against the unsharded one on the same state
        h = out["card"]["h"]
        sv, si = tf.topk_logits(h, on_card["unembed"], K, mesh=mc)
        uv, ui = tf.topk_logits(h, on_card["unembed"], K)
        check(torch.equal(si, ui) and bool(torch.allclose(sv, uv, rtol=RTOL,
                                                          atol=ATOL)),
              f"{name}: the sharded head differs from the unsharded one")
        tok = si[:, :1]
        for step in range(steps):
            got, _ = tf.serve_step(on_card, out["card"]["cache"], tok,
                                   P + step, c, top_k=K + 1, mesh=mc)
            want, _ = tf.serve_step(on_cpu, out["cpu"]["cache"], tok.cpu(),
                                    P + step, c, top_k=K + 1, mesh=mh)
            check(lm_topk_agree(got, want, "float32", K),
                  f"{name}: EP serve_step step {step} on the card differs "
                  "from the CPU mesh")
            tok = got[1][:, :1]
        errs += [normwise(out["card"]["cache"][key], out["cpu"]["cache"][key])
                 for key in ("k", "v")]
        rec[name] = max(errs)
        check(rec[name] <= LM_TOL["float32"],
              f"{name}: card mesh vs CPU mesh {errs} > {LM_TOL['float32']}")

    # an EP step beside a non-EP step on the card: bf16, 16 rows
    cb = dataclasses.replace(cfg2, compute_dtype=torch.bfloat16)
    served = tf.serving_params(on_card, cb)
    x = prompt[:, :P]
    h, pre = tf.prefill(served, x, cb)
    cache = tf.init_kv_cache(cb, x.shape[0], P + 1, device=dev)
    for key in ("k", "v"):
        cache[key][:, :, :P] = pre[key]
    tok = tf.topk_logits(h, served["unembed"], K)[1][:, :1]
    mesh = make_mesh(LM_MESHES[0], ("data", "model"), [dev] * SHARDS)
    ms = {}
    for label, m in (("non_ep", None), ("ep", mesh), ("non_ep", None),
                     ("ep", mesh)):
        times = []
        for _ in range(LM_MESH_STEP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tf.serve_step(served, cache, tok, P, cb, top_k=K, mesh=m)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms[label] = float(np.median(times))
    rec["step_ms"] = ms
    print(f"lm {cfg2.name} x{LM_CPU_LAYERS} on {SHARDS} logical shards of the "
          f"card: EP + sharded head vs a CPU mesh, fp32, normwise "
          f"{ {k: v for k, v in rec.items() if k != 'step_ms'} }; sharded "
          f"head id for id the unsharded one; a bf16 step of "
          f"{x.shape[0]} rows: EP on {LM_MESHES[0]} {ms['ep']:.3f} ms, "
          f"non-EP {ms['non_ep']:.3f} ms (median of {LM_MESH_STEP_REPS}, "
          f"second of two turns)", flush=True)
    return rec


def scout_cut_path(dev) -> None:
    """Step 17(d): llama4-scout at full width cut to 2 layers (the
    48-layer model's 407 GB of fp32 weights do not fit one card): a
    prefill of 4 x 256 tokens and 8 greedy steps through top-1 routing,
    GQA 40/8 and the 202,048-word head; finite, descending, the float64
    witness, and B1-B6 launched 0 times."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import count_params
    t_phase = time.perf_counter()
    full = get_arch(SCOUT_ARCH).make_config()
    check(full.param_count() == SCOUT_PARAMS,
          f"{SCOUT_ARCH}: param_count {full.param_count()}")
    cfg = dataclasses.replace(full, n_layers=LM_CPU_LAYERS)
    B, P, T, K, V = SCOUT_BATCH, SCOUT_PROMPT, SCOUT_STEPS, LM_TOP_K, \
        cfg.vocab_size
    prompt = torch.from_numpy(
        next(lm_batches(SEED, V, B, P))["tokens"]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    served = tf.serving_params(params, cfg)
    n = count_params(params)
    check(n == cfg.param_count(), f"{SCOUT_ARCH} x2: {n} parameters drawn")
    del params
    step_ms, aux = [], []
    cache, fed, outs = lm_decode(served, cfg, prompt, T, K, timed=step_ms,
                                 moe_aux=aux)
    torch.cuda.synchronize()
    launches = read_counters()
    check(not any(launches.values()),
          f"the {SCOUT_ARCH} path launched a kernel {launches}")
    for vals, ids in outs:
        check(vals.shape == (B, K) and bool(torch.isfinite(vals).all())
              and bool((vals[:, :-1] >= vals[:, 1:]).all())
              and bool(((ids >= 0) & (ids < V)).all()),
              f"{SCOUT_ARCH}: top-{K} not finite, descending and in range")
    h_last = tf.decode_hidden(served, cache, fed[-1], P + T - 1, cfg)
    peak_bytes = torch.cuda.max_memory_allocated()
    head_ranks = lm_head_witness(h_last, served["unembed"], *outs[-1])
    check(head_ranks > 0, f"{SCOUT_ARCH}: no rank of the head stood clear")
    del served, cache
    torch.cuda.empty_cache()
    med = float(np.median(step_ms))
    rec = {"arch": SCOUT_ARCH, "layers": LM_CPU_LAYERS, "params": n,
           "batch": B, "prompt": P, "steps": T,
           "prefill_drop_rate": drop_rates(aux[0]),
           "step_drop_rate_max": max(max(drop_rates(a)) for a in aux[1:]),
           "step_ms_median": med, "peak_bytes": peak_bytes,
           "head_ranks_compared": head_ranks, "launches": launches,
           "phase_s": time.perf_counter() - t_phase,
           "card": gpu_name_and_power()}
    print(f"lm {SCOUT_ARCH} x{LM_CPU_LAYERS} ({rec['card']}): {n} "
          f"parameters; {B} x {P} prefill, {T} steps (median {med:.3f} ms); "
          f"drop rate prefill {rec['prefill_drop_rate']}, steps max "
          f"{rec['step_drop_rate_max']:.4f}; head vs float64 witness "
          f"{head_ranks} of {B * K} ranks id for id; peak "
          f"{peak_bytes / 2**30:.2f} GiB; phase {rec['phase_s']:.1f} s",
          flush=True)
    print("lm scout: " + json.dumps(rec), flush=True)


def lm_train_bounds(cfg, B: int, S: int, param_bytes: int) -> dict:
    """The least time of one LM training step of ``B x S`` tokens: the
    GEMMs' operations (6 x the matmul parameters x tokens: the forward
    and the two products of the backward) plus the causal attention's
    (``3 * 2 * B * S**2 * q_dim`` a layer: QK^T and PV over half the
    square, forward and backward) at the bf16 peak, PLUS AdamW's bytes:
    8 passes over the fp32 parameters' bytes (the gradient written by the
    backward and read by AdamW, the parameters and both moments read and
    written; ``train/optimizer.py`` keeps every leaf dense) at the HBM
    rate. A sum, not a max: the update cannot start before the gradient
    is whole (it is clipped by its global norm). ``remat_ms`` is the
    checkpoints' extra forward (the layers' and the head chunks'),
    printed beside the bound, not in it."""
    L, D = cfg.n_layers, cfg.d_model
    layer = D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D \
        + 3 * D * cfg.d_ff
    matmul = L * layer + D * cfg.vocab_size
    tokens = B * S
    causal = 3 * 2 * B * S * S * cfg.q_dim * L
    ops_ms = 1e3 * (6 * matmul * tokens + causal) / BF16_FLOPS_PER_S
    bytes_ms = 1e3 * 8 * param_bytes / HBM_BYTES_PER_S
    return {"matmul_params": matmul, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": ops_ms + bytes_ms,
            "remat_ms": 1e3 * (2 * matmul * tokens + causal / 3)
            / BF16_FLOPS_PER_S}


def lm_train_path(dev) -> None:
    """Step 18 of the module docstring."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.configs import get_arch
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.train import build
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import count_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import (SimulatedPreemption, Trainer,
                                           TrainerConfig)
    from repro_torch.train.tree import tree_leaves

    t_phase = time.perf_counter()
    gpu = gpu_name_and_power()
    cfg = get_arch(LM_ARCH).make_config()
    check(cfg.param_count() == LM_PARAMS and cfg.remat
          and cfg.compute_dtype == torch.bfloat16,
          f"{LM_ARCH}: {cfg.param_count()} parameters, remat {cfg.remat}, "
          f"{cfg.compute_dtype}")
    V, B, S = cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ
    opt = OptimizerConfig(kind="adamw", lr=TRAIN_LR,
                          warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)

    def on(batch, where):
        return {key: torch.from_numpy(v).to(where) for key, v in
                batch.items()}

    def counted(label, fn):
        """``fn()`` with every kernel count set to 0 just before and read
        just after: no TPU kernel is on this path."""
        torch.cuda.synchronize()
        zero_counters()
        out = fn()
        torch.cuda.synchronize()
        launches = read_counters()
        check(not any(launches.values()),
              f"LM training, {label}: launched a kernel {launches}")
        return out

    # -- (a) full width cut to 2 layers: witness and CPU, fp32 ----------------
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS,
                              logit_chunk=LM_TRAIN_CUT_CHUNK,
                              compute_dtype=torch.float32)
    on_cpu = tf.init_params(cut, torch.Generator().manual_seed(SEED), "cpu")
    on_card = tree_to(on_cpu, dev)
    first = next(lm_batches(SEED, V, LM_TRAIN_CUT_BATCH, LM_TRAIN_CUT_SEQ))
    draw_s = time.perf_counter() - t0

    def loss_cut(p, b):
        return tf.loss_fn(p, b, cut)

    def witness(p, b):
        """Full fp32 logits and ``F.cross_entropy``, no checkpoint: shares
        no code with ``chunked_xent`` or the remat."""
        h, aux = tf.forward(p, b["tokens"],
                            dataclasses.replace(cut, remat=False))
        logits = h.float() @ p["unembed"].float()
        xent = tnf.cross_entropy(logits.reshape(-1, V),
                                 b["labels"].reshape(-1).long())
        return xent + cut.aux_loss_weight * aux / cut.n_layers, {}

    l_card, g_card = counted("the 2-layer cut", lambda: grads(
        loss_cut, on_card, on(first, dev)))
    l_wit, g_wit = grads(witness, on_card, on(first, dev))
    t1 = time.perf_counter()
    l_cpu, g_cpu = grads(loss_cut, on_cpu, on(first, "cpu"))
    cpu_s = time.perf_counter() - t1
    cut_errs = {}
    for side, (lw, gw) in (("witness", (l_wit, g_wit)),
                           ("cpu", (l_cpu, g_cpu))):
        cut_errs[side] = {"loss": abs(float(l_card) - float(lw))
                          / abs(float(lw))}
        cut_errs[side].update({key: normwise(g_card[key], gw[key])
                               for key in gw})
        worst = max(cut_errs[side].values())
        check(worst <= LM_TRAIN_TOL,
              f"LM training, 2-layer cut at fp32: loss_fn on the card vs "
              f"the {side} {worst:.3g} > {LM_TRAIN_TOL}: {cut_errs[side]}")
    cut_s = time.perf_counter() - t0
    print(f"lm train (a): {LM_ARCH} at full width cut to {LM_CPU_LAYERS} "
          f"layers, {LM_TRAIN_CUT_BATCH} x {LM_TRAIN_CUT_SEQ} tokens in "
          f"{LM_TRAIN_CUT_SEQ // LM_TRAIN_CUT_CHUNK} head chunks, fp32: loss "
          f"{float(l_card):.7f}; the loss and every leaf's gradient, "
          f"relative / normwise, vs the witness (full logits, "
          f"F.cross_entropy, no remat) and vs the CPU: "
          f"{json.dumps(cut_errs)} ({cut_s:.1f} s: drawn on the CPU and "
          f"copied {draw_s:.1f} s, the CPU's gradient {cpu_s:.1f} s)",
          flush=True)
    del on_cpu, on_card, g_card, g_wit, g_cpu
    torch.cuda.empty_cache()

    # -- (b) full depth: two gradients of the first batch, bitwise ------------
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    check(count_params(params) == LM_PARAMS,
          f"{LM_ARCH}: {count_params(params)} parameters drawn")
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))

    def stream():
        return lm_batches(SEED, V, B, S)

    def loss(p, b):
        return tf.loss_fn(p, b, cfg)

    batch = on(next(stream()), dev)
    l1, g1 = counted("a full-depth gradient", lambda: grads(loss, params,
                                                            batch))
    l2, g2 = grads(loss, params, batch)
    same = torch.equal(l1, l2) and all(torch.equal(g1[key], g2[key])
                                       for key in g1)
    check(same and bool(torch.isfinite(l1)),
          f"LM training: two gradients of the first batch are not bitwise "
          f"equal (losses {float(l1)}, {float(l2)})")
    grad_s = time.perf_counter() - t0
    del g1, g2
    torch.cuda.empty_cache()

    # -- (c) eight steps through Trainer --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(loss, params, opt, PrefetchLoader(stream),
                 TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                               ckpt_every=TRAIN_STEPS + 1))
    t0 = time.perf_counter()
    counted("the Trainer's steps", tr.run)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    tr.data.close()
    losses = [h["loss"] for h in tr.history]
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
          f"LM training losses not finite: {losses}")
    step_ms = [1e3 * h["step_time"] for h in tr.history]
    med = float(np.median(step_ms[1:]))
    prof = profile_call(f"one {LM_ARCH} training step", lambda: tr.train_step(
        tr.params, tr.opt_state, batch), LM_TRAIN_PROFILE_GROUPS, cpu=False)
    del tr, params, batch
    torch.cuda.empty_cache()

    # -- (d) the smoke config, preempted at step 6 and resumed from step 4 ----
    t0 = time.perf_counter()

    def trainer(**kw):
        _, p, loss_s, data = build(LM_ARCH, B, LM_TRAIN_CUT_SEQ, SEED, dev)
        return Trainer(loss_s, p, opt, PrefetchLoader(data),
                       TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                     **kw))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_train_")
    try:
        ck = dict(ckpt_every=TRAIN_CKPT_EVERY,
                  ckpt_dir=os.path.join(tmp, "ckpt"), keep_ckpts=1)
        whole = trainer(ckpt_every=TRAIN_STEPS + 1)
        counted("the smoke config's run", whole.run)
        cut_run = trainer(fail_at_step=TRAIN_FAIL_AT, **ck)
        try:
            cut_run.run()
            fail(f"LM training: no preemption at step {TRAIN_FAIL_AT}")
        except SimulatedPreemption:
            pass
        cut_run.manager.wait()
        resumed = trainer(**ck)
        resumed.run()
        for t in (whole, cut_run, resumed):
            t.data.close()
        check(resumed.history[0]["step"] == TRAIN_CKPT_EVERY + 1
              and resumed.step == TRAIN_STEPS,
              "LM training: the resumed run did not start from step 4")
        check([h["loss"] for h in resumed.history]
              == [h["loss"] for h in whole.history][TRAIN_CKPT_EVERY:]
              and all(torch.equal(a, b) for a, b in zip(
                  tree_leaves({"p": resumed.params, "o": resumed.opt_state}),
                  tree_leaves({"p": whole.params, "o": whole.opt_state}))),
              "LM training: the resumed run is not bitwise the "
              "uninterrupted one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resume_s = time.perf_counter() - t0

    bounds = lm_train_bounds(cfg, B, S, param_bytes)
    check(bounds["matmul_params"] == LM_MATMUL_PARAMS,
          f"{LM_ARCH}: {bounds['matmul_params']} matmul parameters")
    rec = {"arch": LM_ARCH, "params": LM_PARAMS, "batch": B, "seq": S,
           "steps": TRAIN_STEPS, "losses": losses, "step_ms": step_ms,
           "step_ms_median": med, "tokens_per_s": B * S / (med / 1e3),
           **bounds, "param_bytes": param_bytes, "peak_bytes": peak,
           "cut_errors": cut_errs, "cut_s": cut_s, "grad_s": grad_s,
           "run_s": run_s, "resume_s": resume_s,
           "phase_s": time.perf_counter() - t_phase, "card": gpu}
    if prof is not None:
        rec["step_profile"] = {key: prof[key] for key in ("wall_us",
                                                          "busy_us",
                                                          "launches")}
    print(f"lm train {LM_ARCH} at {gpu}: {TRAIN_STEPS} steps of {B} x {S} "
          f"tokens in {run_s:.1f} s, losses {[round(x, 4) for x in losses]}; "
          f"step median (steps 2-{TRAIN_STEPS}) {med:.2f} ms (all "
          f"{[round(x, 2) for x in step_ms]}), {rec['tokens_per_s']:.0f} "
          f"tokens/s; bound {bounds['bound_ms']:.2f} ms (GEMMs and causal "
          f"attention {bounds['ops_ms']:.2f} ms at 989 TFLOP/s bf16, AdamW's "
          f"8 passes over {param_bytes / 1e9:.2f} GB {bounds['bytes_ms']:.2f} "
          f"ms at 3.35 TB/s): {med / bounds['bound_ms']:.2f}x; the remat's "
          f"extra forward {bounds['remat_ms']:.2f} ms (not in the bound); "
          f"peak memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB); two "
          f"full-depth gradients bitwise equal ({grad_s:.1f} s); the smoke "
          f"config's preempted run resumed bitwise ({resume_s:.1f} s); phase "
          f"{rec['phase_s']:.1f} s", flush=True)
    print("lm train: " + json.dumps(rec), flush=True)


def sharded_path(servers, U_all, results, cpu_ctx, dev) -> dict:
    """Step 15 of the module docstring. ``results`` holds the LSHTC-like
    ``naive`` and ``norm`` runs of the main path; ``cpu_ctx`` is a CPU
    context over the same catalogue and index. Returns B4's row of the
    kernels line."""
    import numpy as np
    import torch
    from repro_torch.core import (EngineContext, get_engine,
                                  hierarchical_merge_topk,
                                  sharded_blocked_topk, sharded_naive_topk)
    from repro_torch.core.index import build_index
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    t_phase = time.perf_counter()
    srv = servers[LSH]
    gctx = srv.ctx
    T = gctx.targets
    M, R = T.shape
    ml = M // SHARDS
    U64 = U_all[LSH][:BATCH]
    nb = SHARDED_BLOCKED_QUERIES
    t0 = time.perf_counter()
    slabs = [build_index(T[s * ml:(s + 1) * ml], device=dev)
             for s in range(SHARDS)]
    lists = {dev.type: tuple(torch.cat([getattr(i, f) for i in slabs], 1)
                             for f in ("order_desc", "t_sorted_desc"))}
    lists["cpu"] = tuple(x.cpu() for x in lists[dev.type])
    print(f"sharded: {SHARDS} slab indices of {ml} x {R} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    where = {dev.type: (dev, T, gctx.index), "cpu": (
        torch.device("cpu"), cpu_ctx.targets, cpu_ctx.index)}
    specs = (("data", None), (None, "data"), (None, "data"))

    def strategies(key):
        """The four strategies on 4 shards of ``key``'s device, each
        result on the host with its seconds."""
        d, Tw, index = where[key]
        devs = [d] * SHARDS
        mesh = make_mesh((SHARDS,), ("data",), devs)
        mesh2 = make_mesh((2, 2), ("pod", "data"), devs)
        ctx4 = EngineContext(Tw, index=index, block_size=gctx.block_size,
                             device=d)
        ctx4._mesh = mesh
        U = torch.from_numpy(U64).to(d)
        calls = {
            "naive": lambda: sharded_naive_topk(
                mesh, ("data", None), ("data",))(Tw, U, K),
            "blocked": lambda: sharded_blocked_topk(mesh, specs, ("data",))(
                Tw, *lists[key], U[:nb].contiguous(), K, SHARDED_BLOCK),
            "hierarchical": lambda: hierarchical_merge_topk(
                mesh2, (("pod", "data"), None), ("data",), ("pod",))(
                Tw, U, K),
            "norm": lambda: get_engine("norm_sharded").run(ctx4, U, K)}
        out = {}
        for name, call in calls.items():
            t0 = time.perf_counter()
            res = call()
            if d.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            out[name] = (type(res)(*(x.cpu().numpy() for x in res[:4])),
                         secs)
        check(ctx4.layout("norm_sharded").n_shards == SHARDS,
              "the norm_sharded context did not deal 4 shards")
        return out

    # -- the path, counted -----------------------------------------------------
    torch.cuda.synchronize()
    topk_mips.launches = gather_scores.launches = 0
    gather_scores.path_launches = dict.fromkeys(gather_scores.path_launches,
                                                0)
    n_lat = len(srv.stats["norm_sharded"].lat_us_ring) \
        if "norm_sharded" in srv.stats else 0
    t0 = time.perf_counter()
    one = srv.query(U64, K, method="norm_sharded")
    one_s = time.perf_counter() - t0
    card = strategies(dev.type)
    torch.cuda.synchronize()
    b4, b4_paths = gather_scores.launches, dict(gather_scores.path_launches)
    b1 = topk_mips.launches
    one_lat = list(srv.stats["norm_sharded"].lat_us_ring)[n_lat:]

    # (a) one shard on the card: exact, and the single-host scan's counts
    check(gctx.layout("norm_sharded").n_shards == torch.cuda.device_count(),
          "the default mesh is not every visible card")
    naive, norm = (type(results[LSH, m])(*(x[:BATCH] for x in
                                           results[LSH, m][:4]))
                   for m in ("naive", "norm"))
    check(agrees_with(one, naive),
          f"{LSH}: norm_sharded (default mesh) differs from naive")
    for field in ("n_scored", "depth"):
        check(np.array_equal(getattr(one, field), getattr(norm, field)),
              f"{LSH}: norm_sharded {field} on the default mesh differs "
              "from norm's on the same chunk")
    print(f"sharded (a): {BATCH} {LSH} queries through norm_sharded on the "
          f"default mesh ({torch.cuda.device_count()} shard): "
          f"{np.mean(one_lat):.1f} us/query (host {1e6 * one_s / BATCH:.1f})"
          f" against norm's {srv.stats['norm'].us_per_query:.1f}; exact, "
          f"n_scored and depth equal to norm's (mean depth "
          f"{one.depth.mean():.1f})", flush=True)

    # (b) 4 logical shards on the card against the CPU mesh
    t0 = time.perf_counter()
    cpu = strategies("cpu")
    cpu_s = time.perf_counter() - t0
    for name, (res, secs) in card.items():
        n = res.values.shape[0]
        want = type(naive)(*(x[:n] for x in naive[:4]))
        check(agrees_with(res, want),
              f"{LSH}: sharded {name} (4 shards) differs from naive")
        ref, ref_s = cpu[name]
        check(agrees_with(res, ref),
              f"{LSH}: sharded {name} on the card differs from the CPU mesh")
        for field in ("n_scored", "depth"):
            check(np.array_equal(getattr(res, field), getattr(ref, field)),
                  f"{LSH}: sharded {name} {field} on the card "
                  f"{getattr(res, field)[:4].tolist()} != on the CPU "
                  f"{getattr(ref, field)[:4].tolist()}")
        print(f"  sharded {name:>12s} x{SHARDS} on the card: {n} queries in "
              f"{1e3 * secs:.1f} ms ({1e6 * secs / n:.1f} us/query; CPU "
              f"mesh {ref_s:.2f} s), scored share "
              f"{res.n_scored.mean() / M:.4%} of M, depth mean "
              f"{res.depth.mean():.1f}; equal to the CPU mesh's", flush=True)
    steps = int(card["blocked"][0].depth[0]) // SHARDED_BLOCK
    check(b4 > 0 and b4 == steps,
          f"the sharded blocked path launched gather_scores {b4} times in "
          f"{steps} steps (one a step expected)")
    check(b1 == 0, f"the sharded phase launched topk_mips {b1} times")
    print(f"sharded path: gather_scores launches={b4} (by path {b4_paths}) "
          f"in {steps} blocked steps; CPU mesh replay {cpu_s:.1f} s",
          flush=True)

    # (c) B4 at the blocked strategy's first step: every shard's lanes,
    # at the path's queries and at a 64-query micro-batch
    od = lists[dev.type][0]
    stacked = od.reshape(R, SHARDS, ml).transpose(0, 1).reshape(SHARDS, -1)
    base = (torch.arange(SHARDS, device=dev, dtype=torch.int32)
            * ml)[:, None, None]

    def first_step(nq):
        """``(label, T, ids, U, timed)`` of the first step's B4 launch
        for ``nq`` queries: ``[SHARDS * nq, R * block]`` ids."""
        Ub = torch.from_numpy(U64[:nq]).to(dev)
        cols = torch.arange(SHARDED_BLOCK, device=dev)
        cols = torch.where((Ub < 0)[:, :, None], ml - 1 - cols, cols)
        flat = (torch.arange(R, device=dev)[None, :, None] * ml
                + cols).reshape(-1)
        cand = stacked[:, flat].reshape(SHARDS, nq, -1)
        ids = (cand + base).reshape(SHARDS * nq, -1).contiguous()
        return (f"sharded bta first step, {nq} queries", T, ids,
                Ub.repeat(SHARDS, 1).contiguous(), True)
    cases = [first_step(nb), first_step(BATCH)]
    rec = compare_gather(cases)[cases[0][0]]
    print(f"sharded phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return b4_row("gather_scores[sharded bta]", rec, b4, rec["max_abs_err"])


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


def b4_row(name, rec, launches, max_abs_err) -> dict:
    """A row of the kernels line for one timed ``gather_scores`` case."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather_scores.cu",
            "replaces": REPLACES["gather_scores"], "launches": launches,
            "max_abs_err": max_abs_err,
            **{key: rec[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}


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
    from repro_torch.core.engines import (EngineContext, get_engine,
                                          list_engines)
    from repro_torch.core.index import TopKIndex
    from repro_torch.core.seplr import random_model
    from repro_torch.kernels.gather_scores import FEW_LANES, gather_scores
    from repro_torch.kernels.topk_mips import topk_mips
    from repro_torch.serving.server import TopKServer

    cats = catalogues()
    rng = np.random.default_rng(SEED)
    servers, U_all, warm_s = {}, {}, {}
    for name, m, r, dist, sparsity in cats:
        t0 = time.perf_counter()
        model = random_model(rng, m, r, dist, sparsity, name=name,
                             device=dev)
        U_all[name] = queries(rng, N_QUERIES, r, dist)
        srv = servers[name] = TopKServer(model, max_batch=BATCH, device=dev)
        # the default warmup (every executable engine, a batch per sign
        # bucket for the list engines), each engine's share timed on its
        # own; ta, host-bound at ~2,500 steps a batch whatever its size,
        # only at the 64-query bucket every phase serves it in
        for eng in sorted((e.name for e in list_engines()
                           if e.has_executable), key=lambda n: n == "ta"):
            t_eng = time.perf_counter()
            srv.warmup(K, batch_sizes=(BATCH,) if eng == "ta" else None,
                       engines=[eng])
            torch.cuda.synchronize()
            warm_s[name, eng] = time.perf_counter() - t_eng
        print(f"{name}: M={m} R={r} built and warmed in "
              f"{time.perf_counter() - t0:.1f} s, of it by engine "
              + ", ".join(f"{e} {t:.1f} s" for (n, e), t in warm_s.items()
                          if n == name), flush=True)

    # -- the kernel against its plain version on the card ---------------------
    compare, library_ms = {}, {}
    for name, *_rest in cats:
        cat = servers[name].ctx.catalog
        U = torch.from_numpy(U_all[name][:BATCH]).to(dev)
        compare[name] = compare_modes(cat, U, K, name, timing=True)
        library_ms[name] = timed_ms_cold(
            lambda: torch.topk(torch.matmul(U, cat.T_sorted.T), K), 10)
        print(f"  {name:>18s} library torch.topk(torch.matmul(U, T.T)): "
              f"{library_ms[name]:.4g} ms", flush=True)
    compare.update(edge_cases(rng, dev))
    lsh_modes = compare[LSH]
    print("topk_mips phases at " + LSH + ": " + json.dumps({
        mode: {key: rec[key] for key in ("ms", "ms_warm", "score_ms",
                                         "walk_ms", "scratch_bytes")}
        for mode, rec in lsh_modes.items()}), flush=True)

    # -- kernel B4 against its plain version on the card ----------------------
    lsh, bc = LSH, BC
    first_tail = servers[lsh].ctx.layout("list_major").prefix_steps(
        servers[lsh].block_size)
    gather_cases = []
    for name in (lsh, bc):
        ctx = servers[name].ctx
        U = torch.from_numpy(U_all[name][:BATCH]).to(dev)
        ids = tail_ids(ctx.index, U, ctx.block_size, first_tail)
        gather_cases.append((f"{name} tail block", ctx.targets, ids, U,
                             name == lsh))
    T0, ids0, U0 = gather_cases[0][1:4]
    n_few = min(4, FEW_LANES - 1)
    gather_cases += [
        (f"first {n_few} lanes", T0, ids0[:n_few].contiguous(),
         U0[:n_few].contiguous(), True),
        ("1-D, C = 1000", T0, ids0[0, :1000].contiguous(),
         U0[0].contiguous(), True)]
    compare_b4 = compare_gather(gather_cases)
    sweep = path_sweep(T0, ids0, U0)

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
    gather_scores.path_launches = dict.fromkeys(gather_scores.path_launches,
                                                0)
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
    bta_path_launches = dict(gather_scores.path_launches)
    peak_bytes = torch.cuda.max_memory_allocated()
    lsh_tail = bta_steps[lsh, "mixed"].get("tail", 0)
    check(bta_launches > 0 and lsh_tail > 0,
          f"the LSHTC-like bta run launched gather_scores {bta_launches} "
          f"times in {lsh_tail} tail steps: its tail did not run")
    check(bta_launches == sum(st.get("tail", 0) + st.get("gather", 0)
                              for st in bta_steps.values()),
          "gather_scores launches differ from the bta tail steps")

    for name, m, r, dist, _ in cats:
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
    nn_naive = results[bc, "naive", "nonneg"] = servers[bc].query(
        U_nonneg, K, method="naive")
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
    print(f"bta path: gather_scores launches={bta_launches} (by path "
          f"{bta_path_launches}) "
          f"topk_mips launches={topk_mips.launches} in {bta_seconds:.1f} s; "
          f"peak device memory={peak_bytes / 2**20:.1f} MiB", flush=True)
    # device activity only: the chunk's ~300 steps of host-side operator
    # events took ~26 s to post-process (cut for the script's time)
    profile_call(f"one {BATCH}-query {lsh} bta chunk",
                 lambda: servers[lsh].query(U_all[lsh][:BATCH], K),
                 {"B4 gather_scores_*_kernel": "gather_scores_"}, cpu=False)

    # -- the ta path, counted -------------------------------------------------
    ta_row = ta_path(servers, U_all, results, card.depth, cpu_ctx)
    recsys_rows = recsys_path(dev)
    train_rows = train_path(dev)

    # -- auto, the admission ladder and the host oracles ---------------------
    bc_index = servers[bc].ctx.index
    cpu_ctxs = {lsh: cpu_ctx, bc: EngineContext(
        servers[bc].ctx.targets.cpu(), device="cpu",
        index=TopKIndex(**{f.name: getattr(bc_index, f.name).cpu()
                           for f in dataclasses.fields(TopKIndex)}))}
    auto_path(servers, U_all, results, cpu_ctxs)
    ladder_path(servers, U_all, results, dev)
    oracle_path(dev)
    stream_rows = streaming_path(servers, U_all, dev)
    lsm_rows = lsm_async_path(servers, U_all, dev)
    sharded_row = sharded_path(servers, U_all, results, cpu_ctx, dev)
    lm_path(dev, LM_ARCH, LM_PARAMS)
    torch.cuda.empty_cache()
    lm_path(dev, MOE_ARCH, MOE_PARAMS)
    torch.cuda.empty_cache()
    scout_cut_path(dev)
    torch.cuda.empty_cache()
    lm_train_path(dev)

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
        "library_ms": library_ms[lsh],
    } for mode in MODES]}
    b4_err = max(rec["max_abs_err"] for rec in compare_b4.values())
    kernels["kernels"] += [
        b4_row("gather_scores", compare_b4[f"{lsh} tail block"],
               bta_path_launches["lanes"], b4_err),
        b4_row("gather_scores[few lanes]",
               compare_b4[f"first {n_few} lanes"],
               bta_path_launches["rows"], b4_err),
        ta_row]
    kernels["kernels"].extend(recsys_rows)
    kernels["kernels"].extend(train_rows)
    kernels["kernels"].extend(stream_rows)
    kernels["kernels"].extend(lsm_rows)
    kernels["kernels"].append(sharded_row)
    for row in kernels["kernels"]:
        check(row["launches"] > 0,
              f"the main path launched {row['name']} 0 times")
    print("gather_scores path sweep (cold ms by lanes): "
          + json.dumps(sweep), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
