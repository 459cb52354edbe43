// Exact top-K maximum-inner-product scan over a norm-sorted catalogue,
// written for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of repro/kernels/topk_mips.py:
//   topk_mips_pallas_batched_prefetch  -> mode TWO_LEVEL_BATCHED
//   topk_mips_pallas_prefetch          -> mode TWO_LEVEL_TILE
//   topk_mips_pallas, topk_mips_pallas_batched -> mode SINGLE_LEVEL
// It computes what they compute: per query, walk the first n_tiles
// catalogue tiles (block_m rows each, decreasing-norm order) and, for
// every tile whose Cauchy-Schwarz bound ||u||*max_norm(tile) is STRICTLY
// above the running K-th best, score the tile and merge it into the
// carried top-K (the carry wins ties; within a tile the lower row wins).
// Rows at or past num_real are zero padding and score NEG_INF (-1e30).
// Output per query: values [k], local row ids [k] and stats [3] = (rows
// scored, tiles visited, tiles loaded), column for column as the
// reference.
//
// The invariant. Tiles are walked in increasing row order and the carry
// wins ties, so merging a visited tile is the same as merging only the
// tile's top kk = min(k, block_m) rows in (value desc, row asc) order: a
// row outside that list has kk rows of its own tile ahead of it. So the
// scoring runs in parallel over tiles and queries, and only the gate
// (bound > running K-th best) stays sequential per query.
//
// What bounds it on an H100. The work the gate needs is fp32 FMAs over the
// visited rows (2 x rows x R flops at 67 TFLOP/s) and one read of the live
// prefix (3.35 TB/s); at the LSHTC-like 325,632 x 100 catalogue and B = 64
// the FMAs dominate. Scoring one query per block would re-read the prefix
// once per query (B x 130 MB through a 50 MB L2) on only B SMs.
//
// Phase 1 (score_tiles_kernel). A block owns a group of up to 64 queries
// (grid y) and a contiguous run of tiles (grid x) of the group's largest
// live prefix, so every tile is read once per query group and the runs
// fill the card at any B. Catalogue rows stream through a ring of shared-
// memory stages filled by 1-D bulk copies (cp.async.bulk completing on an
// mbarrier; a span of whole rows, 16-byte aligned whenever block_m * R is
// a multiple of 4, else 4-byte cp.async arriving on the same barrier), so
// the loads of the next stages overlap the FMAs. The group's queries sit
// transposed in shared memory; each thread accumulates a 4-query x 4-row
// register micro-tile in fp32 FMA, reading V = 4, 2 or 1 columns a load.
// Each finished tile's scores [queries, block_m] sit in shared memory. For
// kk <= 16 four threads per query each keep the top kk (rounded up to 4,
// 8, 12 or 16) of a quarter of the rows in registers and the query's first
// thread merges the four lists, so every lane works on its own query (a
// warp-wide arg-max per query and round is a chain of dependent reductions
// that 8 warps cannot hide). Past kk = 16 a list per thread no longer fits
// registers, and kk such arg-max rounds (two dependent warp reductions and
// a 4-byte store each) held phase 1 at 4.03 ms at kk = 256 on an H100,
// against 0.29 ms at k = 10 (chip_smoke.py's score_ms, PERF.md). There a
// warp sorts the tile's block_m scores as 64-bit (value, row) keys in a
// bitonic network held in registers (32 keys a lane at block_m = 1024):
// O(log^2 block_m) data-parallel steps, each lane's keys a run so that only
// 15 steps exchange across lanes, and kk coalesced stores. The caller picks
// the selection (kernels/topk_mips.py: select_path). The sort is a kernel
// of its own per sort width (score_tiles_kernel<V, NPER>, a tile padded to
// 64, 256 or 1,024 keys), so its key registers weigh neither on the lists'
// kernel nor on smaller tiles. The lists and the tile's maximum go to
// global scratch. A block scores and selects in turn: at B = 64 one ~200
// KB block per SM, while at small B two fit, so that one selects while the
// other's loads fly. There the registers decide: the lists' and the
// 256-key sort's kernels are held to 128 a thread (two blocks), since at
// 141 the sort's kernel ran one block per SM and phase 1 at B = 8, k = 42
// took 0.119 ms against 0.091 on an H100 (scripts/b1_rows.py, PERF.md).
//
// Phase 2 (gate_walk_kernel). Each query walks its tiles in order with the
// top-K carry: with the K-th best fixed between merges, one ballot over 32
// tiles' (bound, tile max) marks every visited tile up to the next tile
// whose max beats the K-th best, and only that tile's list is merged (its entries strictly above the K-th best, placed
// by rank: the carry wins ties). So the walk is a chain of merges per
// query, more of them as k grows (486 for the slowest query at k = 522 on
// the LSHTC-like catalogue), each depending on the K-th best the one
// before left. What bounds it is latency: the list and (bound, max) loads
// of each step come from DRAM (the lists outgrow the L2 at k = 522), and
// every merge is a few dependent shared-memory steps. The design hides the
// loads (WalkScan: the rows and the next window's candidate list heads go
// to the L2 ahead of the walk, the guessed next head is in flight during
// the merge before it) and shortens the merge: each carry entry finds how
// far it moves among the few candidates (most need no search), the
// candidates land beside the entries that bound them without a search of
// their own, the merge writes the other half of a ping-pong carry, and the
// next K-th best is read from the carry and candidates before the merge
// (merged_kth) so the next step's loads are in flight while it runs. One
// block walks each query with one barrier per merge: warp 0 walks and
// gathers the next candidates while the other warps merge the current
// ones, so the merge leaves the chain (a warp a query, walking and merging
// in turn, took 0.0887 ms against 0.0708 at B = 8, k = 42 on an H100, and
// was no faster at B = 64, k = 10: scripts/b1_rows.py, PERF.md). The block
// gives each carry entry a merging thread, up to 1,024 threads: 256
// threads merged the 522 entries of the streaming ladder's rung in three
// rounds, and 512 walked it in 0.478 ms against 0.557. The carry halves
// and two candidate buffers (4 k + 4 kk words) sit in shared memory up to
// what a block may opt into (k up to 14,256 at kk = 256, every rung of the
// streaming tier's over-fetch ladder k + 4^n * 32 below it), and the carry
// halves in a global scratch the caller allocates beyond
// (kernels/topk_mips.py: walk_path), which the ladder's last rung, the
// whole catalogue, can reach.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // phase 1: 16 query x 16 row groups
constexpr int kMaxQG = 64;             // queries per phase-1 block
constexpr int kMaxStageRows = 64;
constexpr int kMaxKeep = 16;           // longest per-thread list kept
constexpr size_t kRingBytes = 96 * 1024;
constexpr size_t kQueryBytes = 64 * 1024;
constexpr size_t kScoreBytes = 72 * 1024;   // 64 queries x (256 + 4) rows fit
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kBarBytes = 128;      // the mbarriers, before the ring
constexpr float kNegInf = -1e30f;
constexpr int kMaxWalkThreads = 1024;  // phase 2: a query a block
constexpr size_t kMaxCarrySmem = kMaxSmem - 256;   // past it: static smem

enum Mode { TWO_LEVEL_BATCHED = 0, TWO_LEVEL_TILE = 1, SINGLE_LEVEL = 2 };

__device__ __forceinline__ int tiles_of(const int* live, int b, int mode,
                                        int n_blocks, int superblock) {
  long long n = n_blocks;                               // SINGLE_LEVEL
  if (mode == TWO_LEVEL_TILE) n = live[b];
  if (mode == TWO_LEVEL_BATCHED) n = (long long)live[b] * superblock;
  return (int)(n < 0 ? 0 : (n > n_blocks ? n_blocks : n));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Fill one ring stage with `n_floats` contiguous floats from `src`. The
// bulk path is issued by thread 0 alone; the 4-byte path by every thread,
// each arriving once (the barrier was initialised for that).
__device__ __forceinline__ void fill_stage(float* dst, const float* src,
                                           int n_floats, uint32_t bar,
                                           bool bulk) {
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)n_floats * 4u;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
          :: "r"(bar), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
          : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < n_floats; e += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_addr(dst + e)), "l"(src + e) : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
  }
}

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int V>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[V]) {
  const typename Vec<V>::T v = *reinterpret_cast<const typename Vec<V>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = f[i];
}

// Row stride of the tile-score buffer: a multiple of 32 plus 4, so the
// 4 x 8 (segment, query) threads of a selection warp hit distinct banks.
__host__ __device__ inline int score_stride(int block_m) {
  return (block_m + 31) / 32 * 32 + 4;
}

struct Config {
  int qg, stage_rows, n_stages;
  size_t smem;
};

Config phase1_config(int B, int R, int block_m) {
  Config c;
  c.n_stages = 3;
  c.stage_rows = (int)(4 * (kRingBytes / (3 * (size_t)R * 16)));
  c.stage_rows = c.stage_rows < kMaxStageRows ? c.stage_rows
                                              : kMaxStageRows;
  if (c.stage_rows < 4) {
    c.stage_rows = 4;
    c.n_stages = 2;
  }
  const int tile_rows = (block_m + 3) / 4 * 4;
  if (c.stage_rows > tile_rows) c.stage_rows = tile_rows;
  int qg = kMaxQG;
  const int q_by_u = (int)(4 * (kQueryBytes / ((size_t)R * 16)));
  const int q_by_s =
      (int)(4 * (kScoreBytes / ((size_t)score_stride(block_m) * 16)));
  if (q_by_u < qg) qg = q_by_u;
  if (q_by_s < qg) qg = q_by_s;
  const int q_by_b = (B + 3) / 4 * 4;
  if (q_by_b < qg) qg = q_by_b;
  if (qg < 4) qg = 4;
  for (;;) {
    c.smem = kBarBytes +
             sizeof(float) * ((size_t)c.n_stages * c.stage_rows * R +
                              (size_t)R * qg +
                              (size_t)qg * score_stride(block_m) +
                              (size_t)qg * 4 * kMaxKeep * 2);
    if (c.smem <= kMaxSmem || qg <= 4) break;
    qg -= 4;
  }
  c.qg = qg;
  return c;
}

// A float's bits as an int that orders like the float (-0 taken as +0).
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f + 0.0f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// A score and its tile row as one 64-bit key whose unsigned order is
// (value asc, row desc), so a descending sort gives (value desc, row asc):
// the high word is order_key with its sign bit flipped (the int's order as
// an unsigned order), the low word ~row. A real key's low word has its top
// bit set, so 0 is below every real key: it pads a tile to the sort width.
__device__ __forceinline__ unsigned long long sort_key(float v, int row) {
  return (unsigned long long)((unsigned)order_key(v) ^ 0x80000000u) << 32 |
         (unsigned)~row;
}

__device__ __forceinline__ float sort_key_value(unsigned long long key) {
  return key_value((int)((unsigned)(key >> 32) ^ 0x80000000u));
}

// One merge step of a descending bitonic sort of 32 NPER keys over a warp,
// blocked: element e = NPER lane + i is register i of lane `lane`, its
// partner e ^ J. Strides J < NPER pair two registers of one lane; from
// NPER up the pair spans lanes lane and lane ^ (J / NPER) and is exchanged
// by __shfl_xor_sync, so only 15 of the sort's steps cross lanes (the
// shuffles bound it). A pair whose bit SIZE of e is 0 sorts descending,
// the other ascending; J runs down to 1.
template <int NPER, int SIZE, int J>
__device__ __forceinline__ void bitonic_merge(unsigned long long (&key)[NPER],
                                              int lane) {
  if constexpr (J < NPER) {
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      if ((i & J) == 0) {
        const bool desc = ((NPER * lane + i) & SIZE) == 0;
        const unsigned long long a = key[i], b = key[i + J];
        const bool swap = (a < b) == desc;   // equal keys may swap
        key[i] = swap ? b : a;
        key[i + J] = swap ? a : b;
      }
    }
  } else {
    // SIZE > J >= NPER > i: bit SIZE of e is lane's alone
    const bool desc = ((NPER * lane) & SIZE) == 0;
    // the lower element of a descending pair keeps the larger key
    const bool keep_max = ((lane & (J / NPER)) == 0) == desc;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const unsigned long long other =
          __shfl_xor_sync(0xffffffffu, key[i], J / NPER);
      const bool take = (other > key[i]) == keep_max;
      key[i] = take ? other : key[i];
    }
  }
  if constexpr (J > 1) bitonic_merge<NPER, SIZE, J / 2>(key, lane);
}

template <int NPER, int SIZE = 2>
__device__ __forceinline__ void bitonic_sort(unsigned long long (&key)[NPER],
                                             int lane) {
  bitonic_merge<NPER, SIZE, SIZE / 2>(key, lane);
  if constexpr (SIZE < 32 * NPER) bitonic_sort<NPER, SIZE * 2>(key, lane);
}

// The tile-wide selection (kMaxKeep < kk <= block_m): one warp sorts one
// query's block_m scores `sq` (its row of the tile-score buffer) as keys,
// padded with 0 to 32 NPER >= block_m, all in registers and shuffles. The
// first kk go out as (value, row) pairs through the same row, now free:
// each lane writes its run of NPER there, then every store to the scratch
// takes 32 consecutive entries. Lane 0 writes key 0's value as the max.
template <int NPER>
__device__ void tile_topk_sort(float* sq, int block_m, int kk, int row0,
                               float* out_v, int* out_r, float* out_max) {
  const int lane = threadIdx.x & 31;
  unsigned long long key[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int row = NPER * lane + i;
    key[i] = row < block_m ? sort_key(sq[row], row) : 0ull;
  }
  bitonic_sort<NPER>(key, lane);
  if (lane == 0) *out_max = sort_key_value(key[0]);
  int* sr = reinterpret_cast<int*>(sq);
  __syncwarp();                    // every lane has read its scores
#pragma unroll
  for (int i = 0; i < NPER; ++i)
    if (NPER * lane + i < kk) sq[NPER * lane + i] = sort_key_value(key[i]);
  __syncwarp();
  for (int j = lane; j < kk; j += 32) out_v[j] = sq[j];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NPER; ++i)
    if (NPER * lane + i < kk)
      sr[NPER * lane + i] = row0 + (int)~(unsigned)key[i];
  __syncwarp();
  for (int j = lane; j < kk; j += 32) out_r[j] = sr[j];
}

// The common selection (kk <= KB <= kMaxKeep). Thread (q, s) = (tid / 4,
// tid % 4) scans rows s, s + 4, ... of query q's scores and keeps its top
// KB in registers, sorted by (value desc, row asc) with a branch-free
// insertion (rows come in ascending order, so a tie stays behind). A
// query's top kk are among its four lists: they go to shared memory and
// the query's first thread merges them. Every lane works on its own
// query, so the warp's latency is spread over 8 queries at once. KB is kk
// rounded up to 4: one 16-entry length for every kk <= 16 made phase 1
// 12% slower at k = 10 on an H100 (chip_smoke.py's score_ms, PERF.md).

template <int KB>
__device__ void select_tile_lists(const float* sc, int stride,
                                  const int* ntl, int nq, int t, int qbase,
                                  int n_blocks, int block_m, int kk,
                                  float* keep_v, int* keep_r, float* lvals,
                                  int* lids, float* tmax) {
  const int q = threadIdx.x >> 2;
  const int s = threadIdx.x & 3;
  const bool on = q < nq && t < ntl[q];
  float lv[KB];
  int lr[KB];
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    lv[i] = -__builtin_huge_valf();
    lr[i] = INT_MAX;
  }
  if (on) {
    const float* sq = sc + (size_t)q * stride;
#pragma unroll 4
    for (int row = s; row < block_m; row += 4) {
      const float v = sq[row];
      if (v > lv[KB - 1]) {
#pragma unroll
        for (int i = KB - 1; i >= 0; --i) {
          const int up = i > 0 ? i - 1 : 0;
          if (i > 0 && lv[up] < v) {
            lv[i] = lv[up];
            lr[i] = lr[up];
          } else if (lv[i] < v) {
            lv[i] = v;
            lr[i] = row;
          }
        }
      }
    }
  }
  if (q < nq) {
    float* mv = keep_v + (size_t)threadIdx.x * KB;
    int* mr = keep_r + (size_t)threadIdx.x * KB;
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      mv[i] = lv[i];
      mr[i] = lr[i];
    }
  }
  __syncwarp();
  if (on && s == 0) {
    const float* qv = keep_v + (size_t)threadIdx.x * KB;
    const int* qr = keep_r + (size_t)threadIdx.x * KB;
    const size_t slot = (size_t)(qbase + q) * n_blocks + t;
    int h[4] = {0, 0, 0, 0};
    for (int j = 0; j < kk; ++j) {
      float bv = -__builtin_huge_valf();
      int br = INT_MAX, ba = 0;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (h[a] < KB) {
          const float v = qv[a * KB + h[a]];
          const int r = qr[a * KB + h[a]];
          if (v > bv || (v == bv && r < br)) {
            bv = v;
            br = r;
            ba = a;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) h[a] += a == ba;
      const bool none = br == INT_MAX;   // fewer real rows (only NaNs)
      lvals[slot * kk + j] = none ? kNegInf : bv;
      lids[slot * kk + j] = none ? -1 : t * block_m + br;
      if (j == 0) tmax[slot] = none ? kNegInf : bv;
    }
  }
}

// The selection of one finished tile t for every query of the group that
// has t in its own live prefix (phase 2 reads no other): the lists for
// NPER = 0, else the sort of 32 NPER keys. Each is a kernel of its own,
// since a kernel takes the registers of its largest path: in the lists'
// kernel the sort's keys (64 registers a thread at block_m = 1024) took
// it from 117 to 255 registers with spills, one block per SM where two
// fit at B = 8, and phase 1 at B = 8, k = 10 from 0.106 to 0.19 ms on an
// H100 (PERF.md).
template <int NPER>
__device__ void select_tile(float* sc, int stride, const int* ntl,
                            int nq, int t, int qbase, int n_blocks,
                            int block_m, int kk, float* keep_v, int* keep_r,
                            float* lvals, int* lids, float* tmax) {
  if constexpr (NPER == 0) {
    if (kk <= 4)
      select_tile_lists<4>(sc, stride, ntl, nq, t, qbase, n_blocks, block_m,
                           kk, keep_v, keep_r, lvals, lids, tmax);
    else if (kk <= 8)
      select_tile_lists<8>(sc, stride, ntl, nq, t, qbase, n_blocks, block_m,
                           kk, keep_v, keep_r, lvals, lids, tmax);
    else if (kk <= 12)
      select_tile_lists<12>(sc, stride, ntl, nq, t, qbase, n_blocks,
                            block_m, kk, keep_v, keep_r, lvals, lids, tmax);
    else if (kk <= kMaxKeep)
      select_tile_lists<16>(sc, stride, ntl, nq, t, qbase, n_blocks,
                            block_m, kk, keep_v, keep_r, lvals, lids, tmax);
  } else {
    for (int q = threadIdx.x >> 5; q < nq; q += kThreads / 32) {
      if (t >= ntl[q]) continue;
      const size_t slot = (size_t)(qbase + q) * n_blocks + t;
      float* sq = sc + (size_t)q * stride;
      float* ov = lvals + slot * kk;
      int* orow = lids + slot * kk;
      tile_topk_sort<NPER>(sq, block_m, kk, t * block_m, ov, orow,
                           tmax + slot);
    }
  }
}

// Two blocks an SM where shared memory allows (the header), but for the
// 1,024-key sort, whose keys alone take 64 registers a thread.
template <int V, int NPER>
__global__ void __launch_bounds__(kThreads, NPER <= 8 ? 2 : 1)
score_tiles_kernel(const float* __restrict__ T, const float* __restrict__ U,
                   const int* __restrict__ live, float* __restrict__ lvals,
                   int* __restrict__ lids, float* __restrict__ tmax, int B,
                   int R, int n_blocks, int block_m, int superblock, int kk,
                   int num_real, int mode, int qg, int stage_rows,
                   int n_stages, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  float* us = ring + (size_t)n_stages * stage_rows * R;    // [R][qg]
  const int stride = score_stride(block_m);
  float* sc = us + (size_t)R * qg;                         // [qg][stride]
  float* keep_v = sc + (size_t)qg * stride;        // [qg * 4][kMaxKeep]
  int* keep_r = reinterpret_cast<int*>(keep_v + (size_t)qg * 4 * kMaxKeep);
  __shared__ int ntl[kMaxQG];
  __shared__ int group_tiles;

  const int tid = threadIdx.x;
  const int qbase = blockIdx.y * qg;
  const int nq = min(qg, B - qbase);
  if (tid == 0) group_tiles = 0;
  __syncthreads();
  if (tid < nq) {
    ntl[tid] = tiles_of(live, qbase + tid, mode, n_blocks, superblock);
    atomicMax(&group_tiles, ntl[tid]);
  }
  __syncthreads();
  const int nl = group_tiles;
  const int t_begin = (int)((long long)blockIdx.x * nl / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * nl / gridDim.x);
  if (t_begin >= t_end) return;                 // uniform over the block

  const int n_sub = (block_m + stage_rows - 1) / stage_rows;
  const int n_work = (t_end - t_begin) * n_sub;
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_addr(bars + s)), "r"(bulk ? 1 : kThreads)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int i) {
    const int t = t_begin + i / n_sub;
    const int s = i % n_sub;
    const int rows = min(stage_rows, block_m - s * stage_rows);
    const size_t row0 = (size_t)t * block_m + (size_t)s * stage_rows;
    const int stage = i % n_stages;
    fill_stage(ring + (size_t)stage * stage_rows * R, T + row0 * R,
               rows * R, smem_addr(bars + stage), bulk);
  };
  for (int i = 0; i < n_stages && i < n_work; ++i) issue(i);

  for (int e = tid; e < qg * R; e += kThreads) {
    const int q = e / R;
    const int r = e - q * R;
    us[(size_t)r * qg + q] = q < nq ? U[(size_t)(qbase + q) * R + r] : 0.f;
  }
  __syncthreads();

  const int tq = tid >> 4;          // queries 4 tq .. 4 tq + 3
  const int tr = tid & 15;          // rows tr + 16 j
  const int q0 = 4 * tq;
  for (int i = 0; i < n_work; ++i) {
    const int t = t_begin + i / n_sub;
    const int s = i % n_sub;
    const int rows = min(stage_rows, block_m - s * stage_rows);
    const int stage = i % n_stages;
    mbar_wait(smem_addr(bars + stage), (uint32_t)((i / n_stages) & 1));
    const float* ts = ring + (size_t)stage * stage_rows * R;

    if (q0 < nq) {
      int roff[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) roff[j] = min(tr + 16 * j, rows - 1) * R;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
#pragma unroll 2
      for (int r = 0; r < R; r += V) {
        float x[4][V];
#pragma unroll
        for (int j = 0; j < 4; ++j) load_cols<V>(ts + roff[j] + r, x[j]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float4 u = *reinterpret_cast<const float4*>(
              us + (size_t)(r + v) * qg + q0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[0][j] = fmaf(u.x, x[j][v], acc[0][j]);
            acc[1][j] = fmaf(u.y, x[j][v], acc[1][j]);
            acc[2][j] = fmaf(u.z, x[j][v], acc[2][j]);
            acc[3][j] = fmaf(u.w, x[j][v], acc[3][j]);
          }
        }
      }
      const int grow0 = t * block_m + s * stage_rows;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = tr + 16 * j;
        if (row < rows) {
          const bool real = grow0 + row < num_real;
#pragma unroll
          for (int a = 0; a < 4; ++a)
            if (q0 + a < nq)
              sc[(size_t)(q0 + a) * stride + s * stage_rows + row] =
                  real ? acc[a][j] : kNegInf;
        }
      }
    }
    __syncthreads();               // the stage is read and the scores land
    if (i + n_stages < n_work) issue(i + n_stages);
    if (s == n_sub - 1) {
      select_tile<NPER>(sc, stride, ntl, nq, t, qbase, n_blocks, block_m, kk,
                        keep_v, keep_r, lvals, lids, tmax);
      __syncthreads();             // the next tile overwrites the scores
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// Every 128-byte line of the n floats from p into the L2, lane by lane.
__device__ __forceinline__ void prefetch_row(const float* p, int n,
                                             int lane) {
  for (int i = 32 * lane; i < n; i += 32 * 32) prefetch_l2(p + i);
  if (lane == 0 && n > 0) prefetch_l2(p + n - 1);
}

// Candidates strictly above v among c (descending), `first`/`last` being
// the first and the last: none or all for most carry entries, else a
// binary search.
__device__ __forceinline__ int above(const float* cand_v, int c, float first,
                                     float last, float v) {
  if (last > v) return c;
  if (!(first > v)) return 0;
  int lo = 1, hi = c - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cand_v[mid] > v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge c candidates `cand_v/cand_r` (descending, each above the carry's
// last entry) into the carry `cv/ci` (k entries, descending) as `nv/ni`,
// the carry winning ties. Thread t of nt (a multiple of 32, consecutive t
// in consecutive lanes) takes carry entries j = t, t + nt, ...: entry j
// moves down by n_j, the candidates strictly above it, and the candidates
// q in [n_(j-1), n_j) rank right after entry j - 1, at q + j, so a
// candidate is placed with no search of its own (n_(j-1) comes from the
// lane below, or a second search in lane 0).
__device__ __forceinline__ void merge_carry(const float* cv, const int* ci,
                                            float* nv, int* ni,
                                            const float* cand_v,
                                            const int* cand_r, int c, int k,
                                            int t, int nt) {
  const int lane = t & 31;
  const float first = cand_v[0], last = cand_v[c - 1];
  for (int j0 = 0; j0 < k; j0 += nt) {         // uniform over a warp
    const int j = j0 + t;
    int n = 0;
    if (j < k) {
      const float v = cv[j];
      n = above(cand_v, c, first, last, v);
      if (j + n < k) {
        nv[j + n] = v;
        ni[j + n] = ci[j];
      }
    }
    int lo = __shfl_up_sync(0xffffffffu, n, 1);
    if (lane == 0)
      lo = j == 0 || j >= k ? 0 : above(cand_v, c, first, last, cv[j - 1]);
    if (j < k)
      for (int q = lo; q < n && q + j < k; ++q) {
        nv[q + j] = cand_v[q];
        ni[q + j] = cand_r[q];
      }
  }
}

// The merge's K-th best, from the carry and candidates before it (one
// warp): m candidates make the top k where candidate m - 1 still beats
// carry entry k - m (ties go to the carry), and the K-th best is the
// lower of candidate m - 1 and carry entry k - 1 - m.
__device__ __forceinline__ float merged_kth(const float* cv,
                                            const float* cand_v, int c,
                                            int k, int lane) {
  int m = 0;
  for (int q0 = 0; q0 < c; q0 += 32) {
    const int q = q0 + lane;
    const uint32_t in =
        __ballot_sync(0xffffffffu, q < c && cand_v[q] > cv[k - 1 - q]);
    m += __popc(in);
    if (in != 0xffffffffu) break;
  }
  const float lc = cand_v[m - 1];
  return m >= k ? lc : fminf(lc, cv[k - 1 - m]);
}

// One warp's gate walk over a query's tiles. Each lane holds its tile's
// (bound, max) of three windows of 32 (the next two in flight); one ballot
// marks every visited tile up to the next tile whose max beats the K-th
// best. Its list is read from global scratch (from DRAM where the scratch
// outgrows the 50 MB L2: 161 MB of lists at k = 522, B = 64 and 1,230 live
// tiles), and every merge of a query's chain would wait on that load, so
// the latency is hidden three ways: the query's (bound, max) rows go to
// the L2 at the start, each window's candidate tiles (bound and max above
// the K-th best now, a superset of the ones merged later) have their list
// heads sent to the L2 a window ahead, and the head of the tile the walk
// guesses it merges next is in flight during the merge before it.
struct WalkScan {
  int n_tiles, kk, t0 = 0, visited = 0, guess = -1;
  uint32_t done = 0;
  float bnd[3], mx[3], hv = kNegInf;
  int hr = -1;
  const float* brow;
  const float* mrow;
  const float* lv;    // the query's lists, kk a tile
  const int* li;

  __device__ __forceinline__ float at(const float* row, int t) const {
    return t < n_tiles ? row[t] : kNegInf;   // never visited
  }

  __device__ __forceinline__ void prefetch_head(int tile, float lb,
                                                int w) const {
    if (tile < n_tiles && bnd[w] > lb && mx[w] > lb) {
      const int n = kk < 32 ? kk : 32;
      prefetch_l2(lv + (size_t)tile * kk);
      prefetch_l2(lv + (size_t)tile * kk + n - 1);
      prefetch_l2(li + (size_t)tile * kk);
      prefetch_l2(li + (size_t)tile * kk + n - 1);
    }
  }

  __device__ __forceinline__ void start(int lane) {
    prefetch_row(brow, n_tiles, lane);
    prefetch_row(mrow, n_tiles, lane);
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      bnd[w] = at(brow, 32 * w + lane);
      mx[w] = at(mrow, 32 * w + lane);
    }
    prefetch_head(32 + lane, kNegInf, 1);
  }

  // The next tile to merge under lb (counting the visited tiles up to
  // it), or -1 past the last tile. On a tile, `v`/`r` hold the lane's
  // entry of its list head (lanes below kk) and the next guess's head is
  // in flight.
  __device__ __forceinline__ int next(float lb, int lane, float& v,
                                      int& r) {
    while (t0 < n_tiles) {
      const uint32_t vis = __ballot_sync(0xffffffffu, bnd[0] > lb) & ~done;
      const uint32_t mrg =
          __ballot_sync(0xffffffffu, bnd[0] > lb && mx[0] > lb) & ~done;
      if (mrg == 0) {
        visited += __popc(vis);
        t0 += 32;
        done = 0;
        bnd[0] = bnd[1];
        mx[0] = mx[1];
        bnd[1] = bnd[2];
        mx[1] = mx[2];
        bnd[2] = at(brow, t0 + 64 + lane);
        mx[2] = at(mrow, t0 + 64 + lane);
        prefetch_head(t0 + 32 + lane, lb, 1);
        continue;
      }
      const int p = __ffs(mrg) - 1;
      const uint32_t upto = p == 31 ? 0xffffffffu : ((1u << (p + 1)) - 1u);
      visited += __popc(vis & upto);
      done |= upto;
      const int tile = t0 + p;
      if (tile == guess) {
        v = hv;
        r = hr;
      } else if (lane < kk) {
        v = lv[(size_t)tile * kk + lane];
        r = li[(size_t)tile * kk + lane];
      }
      const uint32_t after = mrg & ~upto;
      guess = after ? t0 + __ffs(after) - 1 : -1;
      if (!after) {
        const uint32_t m2 =
            __ballot_sync(0xffffffffu, bnd[1] > lb && mx[1] > lb);
        if (m2) guess = t0 + 32 + __ffs(m2) - 1;
      }
      if (guess >= 0 && lane < kk) {
        hv = lv[(size_t)guess * kk + lane];
        hr = li[(size_t)guess * kk + lane];
      }
      return tile;
    }
    return -1;
  }

  // Tile `tile`'s candidates, its list entries strictly above lb (a
  // prefix), into `cand_v/cand_r`, and (tile, count) into `ctrl` by lane
  // 0; tile -1 past the last. `v`/`r` are the lane's entry of its head. A
  // head all above lb is followed into the rest of the list, 256 entries
  // a round of loads.
  __device__ __forceinline__ void gather(int tile, float v, int r,
                                         float lb, int lane, float* cand_v,
                                         int* cand_r, int* ctrl) const {
    int c = 0;
    if (tile >= 0) {
      const bool in = lane < kk && v > lb;
      if (in) {
        cand_v[lane] = v;
        cand_r[lane] = r;
      }
      uint32_t m = __ballot_sync(0xffffffffu, in);
      c = __popc(m);
      const float* tv = lv + (size_t)tile * kk;
      const int* tr = li + (size_t)tile * kk;
      for (int j0 = 32; m == 0xffffffffu && j0 < kk; j0 += 256) {
        float x[8];
        int y[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + 32 * u + lane;
          x[u] = j < kk ? tv[j] : kNegInf;
          y[u] = j < kk ? tr[j] : -1;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (m != 0xffffffffu) break;
          const int j = j0 + 32 * u + lane;
          const bool inj = j < kk && x[u] > lb;
          if (inj) {
            cand_v[j] = x[u];
            cand_r[j] = y[u];
          }
          m = __ballot_sync(0xffffffffu, inj);
          c += __popc(m);
        }
      }
    }
    if (lane == 0) {
      ctrl[0] = tile;
      ctrl[1] = c;
    }
  }

  __device__ __forceinline__ void next_merge(float lb, int lane,
                                             float* cand_v, int* cand_r,
                                             int* ctrl) {
    float v = kNegInf;
    int r = -1;
    const int tile = next(lb, lane, v, r);
    gather(tile, v, r, lb, lane, cand_v, cand_r, ctrl);
  }
};

// Phase 2: one block per query, one barrier per merge.
// Warp 0 walks: while warps 1.. merge the current candidates into the
// other half of a ping-pong carry, it takes the merge's K-th best from the
// carry and candidates (merged_kth), finds the next tile under it and
// gathers that tile's candidates into the other candidate buffer.
// The candidates (2 x 2 kk words) sit in shared memory; the carry halves
// (2 x 2 k words) too, or in the query's region of `gcarry` when they do
// not fit (__syncthreads orders the block's global accesses as it does
// its shared ones).
__global__ void __launch_bounds__(kMaxWalkThreads)
gate_walk_kernel(const float* __restrict__ bounds,
                 const int* __restrict__ live,
                 const float* __restrict__ lvals,
                 const int* __restrict__ lids,
                 const float* __restrict__ tmax, float* __restrict__ out_vals,
                 int* __restrict__ out_idx, int* __restrict__ out_stats,
                 float* gcarry, int n_blocks, int block_m, int superblock,
                 int k, int kk, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int ctrl[2][2];          // the next two merges' (tile, count)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  // candidate buffer s: values at cand + 2 kk s, rows kk words on
  float* const cand = reinterpret_cast<float*>(smem);
  auto cand_v = [&](int s) { return cand + 2 * kk * s; };
  auto cand_r = [&](int s) {
    return reinterpret_cast<int*>(cand + 2 * kk * s + kk);
  };
  float* cv = gcarry != nullptr ? gcarry + (size_t)b * 4 * k : cand + 4 * kk;
  int* ci = reinterpret_cast<int*>(cv + k);
  float* nv = reinterpret_cast<float*>(ci + k);
  int* ni = reinterpret_cast<int*>(nv + k);

  for (int j = tid; j < k; j += nt) {
    cv[j] = kNegInf;
    ci[j] = -1;
  }
  WalkScan w;                          // warp 0's
  w.n_tiles = tiles_of(live, b, mode, n_blocks, superblock);
  w.kk = kk;
  w.brow = bounds + (size_t)b * n_blocks;
  w.mrow = tmax + (size_t)b * n_blocks;
  w.lv = lvals + (size_t)b * n_blocks * kk;
  w.li = lids + (size_t)b * n_blocks * kk;
  if (tid < 32) {
    w.start(lane);
    w.next_merge(kNegInf, lane, cand_v(0), cand_r(0), ctrl[0]);
  }
  __syncthreads();                    // the carry and first merge are in
  for (int s = 0;; s ^= 1) {
    const int tile = ctrl[s][0], c = ctrl[s][1];
    if (tile < 0) break;              // uniform over the block
    if (tid < 32) {
      const float lb = merged_kth(cv, cand_v(s), c, k, lane);
      w.next_merge(lb, lane, cand_v(s ^ 1), cand_r(s ^ 1), ctrl[s ^ 1]);
    } else {
      merge_carry(cv, ci, nv, ni, cand_v(s), cand_r(s), c, k, tid - 32,
                  nt - 32);
    }
    __syncthreads();
    float* tv = cv;
    cv = nv;
    nv = tv;
    int* ti = ci;
    ci = ni;
    ni = ti;
  }

  for (int j = tid; j < k; j += nt) {
    out_vals[(size_t)b * k + j] = cv[j];
    out_idx[(size_t)b * k + j] = ci[j];
  }
  if (tid == 0) {
    out_stats[b * 3 + 0] = w.visited * block_m;
    out_stats[b * 3 + 1] = w.visited;
    out_stats[b * 3 + 2] = w.n_tiles;
  }
}

template <int V, int NPER>
cudaError_t launch_score(const Config& c, dim3 grid, cudaStream_t stream,
                         const float* T, const float* U, const int* live,
                         float* lvals, int* lids, float* tmax, int B, int R,
                         int n_blocks, int block_m, int superblock, int kk,
                         int num_real, int mode, int bulk) {
  cudaError_t err = cudaFuncSetAttribute(
      score_tiles_kernel<V, NPER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0, dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, score_tiles_kernel<V, NPER>, kThreads, c.smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // enough tile runs that the groups together fill every SM once
  const long long want =
      ((long long)sms * per_sm + grid.y - 1) / grid.y;
  grid.x = (unsigned)(want < n_blocks ? want : n_blocks);
  if (grid.x == 0) grid.x = 1;
  score_tiles_kernel<V, NPER><<<grid, kThreads, c.smem, stream>>>(
      T, U, live, lvals, lids, tmax, B, R, n_blocks, block_m, superblock, kk,
      num_real, mode, c.qg, c.stage_rows, c.n_stages, bulk);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. Each returns the
// cudaError_t of its launch (0 = launched) and neither synchronises; `live`
// may be null in SINGLE_LEVEL mode. The caller allocates the scratch:
// lvals/lids [B, n_blocks, kk] and tmax [B, n_blocks], kk = min(k, block_m),
// for a k whose carry does not fit shared memory also carry [B, 4 k]
// (4-byte words; null otherwise), and runs phase 1 before phase 2 on one
// stream. T must be 16-byte aligned.

// Phase 1: every (query, tile) of each query group's live prefix scored;
// per (query, tile) its top kk rows and its maximum into the scratch,
// selected by the sort when `sort` is set, else by the register lists
// (kk <= kMaxKeep).
extern "C" int topk_mips_score_launch(const float* T, const float* U,
                                      const int* live, float* lvals,
                                      int* lids, float* tmax, int B, int R,
                                      int n_blocks, int block_m,
                                      int superblock, int kk, int num_real,
                                      int mode, int sort, void* stream) {
  if (mode < 0 || mode > SINGLE_LEVEL || B <= 0 || R <= 0 || kk <= 0 ||
      block_m <= 0 || block_m > 1024 || kk > block_m || n_blocks < 0 ||
      ((uintptr_t)T & 15u) || (!sort && kk > kMaxKeep))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const Config c = phase1_config(B, R, block_m);
  if (c.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int bulk = ((long long)block_m * R) % 4 == 0 ? 1 : 0;
  dim3 grid(1, (B + c.qg - 1) / c.qg);
  cudaStream_t s = (cudaStream_t)stream;
  // the sort pads a tile to 64, 256 or 1024 keys: one kernel each
  const int nper = !sort ? 0 : block_m <= 64 ? 2 : block_m <= 256 ? 8 : 32;
  auto launch = [&](auto v, auto n) {
    return launch_score<decltype(v)::value, decltype(n)::value>(
        c, grid, s, T, U, live, lvals, lids, tmax, B, R, n_blocks, block_m,
        superblock, kk, num_real, mode, bulk);
  };
  auto by_width = [&](auto v) {
    using std::integral_constant;
    switch (nper) {
      case 0: return launch(v, integral_constant<int, 0>());
      case 2: return launch(v, integral_constant<int, 2>());
      case 8: return launch(v, integral_constant<int, 8>());
      default: return launch(v, integral_constant<int, 32>());
    }
  };
  using std::integral_constant;
  cudaError_t err;
  if (R % 4 == 0)
    err = by_width(integral_constant<int, 4>());
  else if (R % 2 == 0)
    err = by_width(integral_constant<int, 2>());
  else
    err = by_width(integral_constant<int, 1>());
  return (int)err;
}

// Phase 2 over the phase-1 scratch, one block per query: its carry in
// shared memory when `carry` is null (4 (4 k + 4 kk) bytes, within
// kMaxCarrySmem), else in `carry` (4 k words a query; the candidates, 4 kk
// words, stay in shared memory).
extern "C" int topk_mips_walk_launch(const float* bounds, const int* live,
                                     const float* lvals, const int* lids,
                                     const float* tmax, float* vals,
                                     int* idx, int* stats, float* carry,
                                     int B, int n_blocks, int block_m,
                                     int superblock, int k, int kk, int mode,
                                     void* stream) {
  if (mode < 0 || mode > SINGLE_LEVEL || B <= 0 || k <= 0 || kk <= 0 ||
      kk > k || block_m <= 0 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem =
      sizeof(float) * (4 * (size_t)kk + (carry != nullptr ? 0 : 4 * (size_t)k));
  if (smem > kMaxCarrySmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gate_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // warp 0 walks, and each carry entry has a thread of its own to merge
  const int want = 32 + (k + 31) / 32 * 32;
  const int threads = want < kMaxWalkThreads ? want : kMaxWalkThreads;
  gate_walk_kernel<<<B, threads, smem, s>>>(
      bounds, live, lvals, lids, tmax, vals, idx, stats, carry, n_blocks,
      block_m, superblock, k, kk, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_mips_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
