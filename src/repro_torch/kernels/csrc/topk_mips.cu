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
// 8, 12 or 16) of a quarter of the
// rows in registers and the query's first thread merges the four lists,
// so every lane works on its own query (a warp-wide arg-max per query and
// round is a chain of dependent reductions that 8 warps cannot hide);
// longer lists take kk rounds of such an arg-max. The lists and the
// tile's maximum go to global scratch. Selection and scoring do not
// overlap: one ~200 KB block per SM runs them in turn.
//
// Phase 2 (gate_walk_kernel). One warp per query walks its tiles in order
// with the top-K carry in shared memory. It reads 32 tiles' (bound, tile
// max) per load; with the K-th best fixed between merges, one ballot marks
// every visited tile up to the next tile whose max beats the K-th best,
// and only that tile's list is merged (its entries strictly above the
// K-th best, placed by rank: the carry wins ties). The warp's carry, its
// merge buffer and the tile's candidates (4 k + 2 kk words) sit in shared
// memory up to k = kMaxSmemK; above it the same layout lives in a global
// scratch the caller allocates, one region per query. That path is slow
// (every carry access goes to L1/L2) but takes any k up to the catalogue,
// which the streaming tier's over-fetch ladder reaches (k + 4^n * 32).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // phase 1: 16 query x 16 row groups
constexpr int kWalkWarps = 4;          // phase 2: queries per block
constexpr int kMaxQG = 64;             // queries per phase-1 block
constexpr int kMaxStageRows = 64;
constexpr int kMaxKeep = 16;           // longest per-thread list kept
constexpr size_t kRingBytes = 96 * 1024;
constexpr size_t kQueryBytes = 64 * 1024;
constexpr size_t kScoreBytes = 72 * 1024;   // 64 queries x (256 + 4) rows fit
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kBarBytes = 128;      // the mbarriers, before the ring
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmemK = 256;         // phase 2: largest shared carry

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

// The general selection (kk > kMaxKeep): one warp picks one query's top
// kk of the tile's block_m scores `sq` in (value desc, row asc) order.
// Lane l holds rows l + 32 i (i < NPER) as order keys in registers; each
// of kk rounds takes the warp's largest key (__reduce_max_sync), then its
// lowest row (__reduce_min_sync), and the winning lane writes it and finds
// its own next best in registers.
template <int NPER>
__device__ void tile_topk_rounds(const float* sq, int block_m, int kk,
                                 int row0, float* out_v, int* out_r,
                                 float* out_max) {
  const int lane = threadIdx.x & 31;
  int key[NPER];
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int row = lane + 32 * i;
    key[i] = row < block_m ? order_key(sq[row]) : INT_MIN;
    live |= (row < block_m ? 1u : 0u) << i;
  }
  int bk = INT_MIN, bi = -1;
  auto scan = [&]() {
    bk = INT_MIN;
    bi = -1;
#pragma unroll
    for (int i = 0; i < NPER; ++i)
      if (((live >> i) & 1u) && (bi < 0 || key[i] > bk)) {
        bk = key[i];
        bi = i;
      }
  };
  scan();
  for (int j = 0; j < kk; ++j) {
    const int m = __reduce_max_sync(0xffffffffu, bk);
    const int mine = bi >= 0 && bk == m ? lane + 32 * bi : INT_MAX;
    // kk <= block_m: a row is always left, so one lane wins each round
    const int r = (int)__reduce_min_sync(0xffffffffu, (unsigned)mine);
    if (mine == r) {
      const float v = key_value(bk);
      out_v[j] = v;
      out_r[j] = row0 + r;
      if (j == 0) *out_max = v;
      live &= ~(1u << bi);
      scan();
    }
  }
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
// has t in its own live prefix (phase 2 reads no other).
__device__ void select_tile(const float* sc, int stride, const int* ntl,
                            int nq, int t, int qbase, int n_blocks,
                            int block_m, int kk, float* keep_v, int* keep_r,
                            float* lvals, int* lids, float* tmax) {
  if (kk <= 4)
    select_tile_lists<4>(sc, stride, ntl, nq, t, qbase, n_blocks, block_m,
                         kk, keep_v, keep_r, lvals, lids, tmax);
  else if (kk <= 8)
    select_tile_lists<8>(sc, stride, ntl, nq, t, qbase, n_blocks, block_m,
                         kk, keep_v, keep_r, lvals, lids, tmax);
  else if (kk <= 12)
    select_tile_lists<12>(sc, stride, ntl, nq, t, qbase, n_blocks, block_m,
                          kk, keep_v, keep_r, lvals, lids, tmax);
  else if (kk <= kMaxKeep)
    select_tile_lists<16>(sc, stride, ntl, nq, t, qbase, n_blocks, block_m,
                          kk, keep_v, keep_r, lvals, lids, tmax);
  else
    for (int q = threadIdx.x >> 5; q < nq; q += kThreads / 32) {
      if (t >= ntl[q]) continue;
      const size_t slot = (size_t)(qbase + q) * n_blocks + t;
      if (block_m <= 256)
        tile_topk_rounds<8>(sc + (size_t)q * stride, block_m, kk,
                            t * block_m, lvals + slot * kk,
                            lids + slot * kk, tmax + slot);
      else
        tile_topk_rounds<32>(sc + (size_t)q * stride, block_m, kk,
                             t * block_m, lvals + slot * kk,
                             lids + slot * kk, tmax + slot);
    }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
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
      select_tile(sc, stride, ntl, nq, t, qbase, n_blocks, block_m, kk,
                  keep_v, keep_r, lvals, lids, tmax);
      __syncthreads();             // the next tile overwrites the scores
    }
  }
}

__global__ void __launch_bounds__(kWalkWarps * 32)
gate_walk_kernel(const float* __restrict__ bounds,
                 const int* __restrict__ live,
                 const float* __restrict__ lvals,
                 const int* __restrict__ lids,
                 const float* __restrict__ tmax, float* __restrict__ out_vals,
                 int* __restrict__ out_idx, int* __restrict__ out_stats,
                 float* gcarry, int B, int n_blocks, int block_m,
                 int superblock, int k, int kk, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + warp;
  if (b >= B) return;                 // no block-wide barrier below
  // the warp's buffers: shared memory, or its region of the global
  // scratch for k > kMaxSmemK (__syncwarp orders global accesses too)
  const size_t words = 4 * (size_t)k + 2 * (size_t)kk;
  float* cv = gcarry != nullptr
                  ? gcarry + (size_t)b * words
                  : reinterpret_cast<float*>(smem) + (size_t)warp * words;
  int* ci = reinterpret_cast<int*>(cv + k);
  float* nv = reinterpret_cast<float*>(ci + k);
  int* ni = reinterpret_cast<int*>(nv + k);
  float* cand_v = reinterpret_cast<float*>(ni + k);
  int* cand_r = reinterpret_cast<int*>(cand_v + kk);

  for (int j = lane; j < k; j += 32) {
    cv[j] = kNegInf;
    ci[j] = -1;
  }
  __syncwarp();
  const int n_tiles = tiles_of(live, b, mode, n_blocks, superblock);
  const float* brow = bounds + (size_t)b * n_blocks;
  const float* mrow = tmax + (size_t)b * n_blocks;
  float lb = kNegInf;
  int visited = 0;

  float nb = 0.f, nm = 0.f;
  if (lane < n_tiles) {
    nb = brow[lane];
    nm = mrow[lane];
  }
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const bool valid = t0 + lane < n_tiles;
    const float bnd = nb, mx = nm;
    if (t0 + 32 + lane < n_tiles) {        // the next 32 tiles, in flight
      nb = brow[t0 + 32 + lane];
      nm = mrow[t0 + 32 + lane];
    }
    uint32_t done = 0;
    for (;;) {
      const uint32_t vis =
          __ballot_sync(0xffffffffu, valid && bnd > lb) & ~done;
      const uint32_t mrg =
          __ballot_sync(0xffffffffu, valid && bnd > lb && mx > lb) & ~done;
      if (mrg == 0) {
        visited += __popc(vis);
        break;
      }
      const int p = __ffs(mrg) - 1;
      const uint32_t upto = p == 31 ? 0xffffffffu : ((1u << (p + 1)) - 1u);
      visited += __popc(vis & upto);
      done |= upto;

      // tile t0 + p: its list entries strictly above lb are a prefix
      const size_t slot = ((size_t)b * n_blocks + t0 + p) * kk;
      int c = 0;
      for (int j0 = 0; j0 < kk; j0 += 32) {
        const int j = j0 + lane;
        const float v = j < kk ? lvals[slot + j] : kNegInf;
        const bool in = j < kk && v > lb;
        if (in) {
          cand_v[j] = v;
          cand_r[j] = lids[slot + j];
        }
        const uint32_t m = __ballot_sync(0xffffffffu, in);
        c += __popc(m);
        if (m != 0xffffffffu) break;
      }
      __syncwarp();
      // carry entry j moves down past every candidate strictly above it
      for (int j = lane; j < k; j += 32) {
        const float v = cv[j];
        int lo = 0, hi = c;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cand_v[mid] > v) lo = mid + 1; else hi = mid;
        }
        const int pos = j + lo;
        if (pos < k) {
          nv[pos] = v;
          ni[pos] = ci[j];
        }
      }
      // candidate q ranks after every carry entry >= it and the
      // candidates ahead of it in its list
      for (int q = lane; q < c; q += 32) {
        const float s = cand_v[q];
        int lo = 0, hi = k;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cv[mid] >= s) lo = mid + 1; else hi = mid;
        }
        const int pos = q + lo;
        if (pos < k) {
          nv[pos] = s;
          ni[pos] = cand_r[q];
        }
      }
      __syncwarp();
      for (int j = lane; j < k; j += 32) {
        cv[j] = nv[j];
        ci[j] = ni[j];
      }
      __syncwarp();
      lb = cv[k - 1];
    }
  }

  for (int j = lane; j < k; j += 32) {
    out_vals[(size_t)b * k + j] = cv[j];
    out_idx[(size_t)b * k + j] = ci[j];
  }
  if (lane == 0) {
    out_stats[b * 3 + 0] = visited * block_m;
    out_stats[b * 3 + 1] = visited;
    out_stats[b * 3 + 2] = n_tiles;
  }
}

template <int V>
cudaError_t launch_score(const Config& c, dim3 grid, cudaStream_t stream,
                         const float* T, const float* U, const int* live,
                         float* lvals, int* lids, float* tmax, int B, int R,
                         int n_blocks, int block_m, int superblock, int kk,
                         int num_real, int mode, int bulk) {
  cudaError_t err = cudaFuncSetAttribute(
      score_tiles_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)c.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0, dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, score_tiles_kernel<V>, kThreads, c.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // enough tile runs that the groups together fill every SM once
  const long long want =
      ((long long)sms * per_sm + grid.y - 1) / grid.y;
  grid.x = (unsigned)(want < n_blocks ? want : n_blocks);
  if (grid.x == 0) grid.x = 1;
  score_tiles_kernel<V><<<grid, kThreads, c.smem, stream>>>(
      T, U, live, lvals, lids, tmax, B, R, n_blocks, block_m, superblock, kk,
      num_real, mode, c.qg, c.stage_rows, c.n_stages, bulk);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. Each returns the
// cudaError_t of its launch (0 = launched) and neither synchronises; `live`
// may be null in SINGLE_LEVEL mode. The caller allocates the scratch:
// lvals/lids [B, n_blocks, kk] and tmax [B, n_blocks], kk = min(k, block_m),
// for k > 256 also carry [B, 4 k + 2 kk] (4-byte words; null otherwise),
// and runs phase 1 before phase 2 on one stream. T must be 16-byte
// aligned.

// Phase 1: every (query, tile) of each query group's live prefix scored;
// per (query, tile) its top kk rows and its maximum into the scratch.
extern "C" int topk_mips_score_launch(const float* T, const float* U,
                                      const int* live, float* lvals,
                                      int* lids, float* tmax, int B, int R,
                                      int n_blocks, int block_m,
                                      int superblock, int kk, int num_real,
                                      int mode, void* stream) {
  if (mode < 0 || mode > SINGLE_LEVEL || B <= 0 || R <= 0 || kk <= 0 ||
      block_m <= 0 || block_m > 1024 || kk > block_m || n_blocks < 0 ||
      ((uintptr_t)T & 15u))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const Config c = phase1_config(B, R, block_m);
  if (c.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int bulk = ((long long)block_m * R) % 4 == 0 ? 1 : 0;
  dim3 grid(1, (B + c.qg - 1) / c.qg);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (R % 4 == 0)
    err = launch_score<4>(c, grid, s, T, U, live, lvals, lids, tmax, B, R,
                          n_blocks, block_m, superblock, kk, num_real, mode,
                          bulk);
  else if (R % 2 == 0)
    err = launch_score<2>(c, grid, s, T, U, live, lvals, lids, tmax, B, R,
                          n_blocks, block_m, superblock, kk, num_real, mode,
                          bulk);
  else
    err = launch_score<1>(c, grid, s, T, U, live, lvals, lids, tmax, B, R,
                          n_blocks, block_m, superblock, kk, num_real, mode,
                          bulk);
  return (int)err;
}

// Phase 2: one warp per query walks the gate over the phase-1 scratch;
// its carry is in shared memory for k <= 256, in `carry` above.
extern "C" int topk_mips_walk_launch(const float* bounds, const int* live,
                                     const float* lvals, const int* lids,
                                     const float* tmax, float* vals,
                                     int* idx, int* stats, float* carry,
                                     int B, int n_blocks, int block_m,
                                     int superblock, int k, int kk, int mode,
                                     void* stream) {
  const bool global_carry = k > kMaxSmemK;
  if (mode < 0 || mode > SINGLE_LEVEL || B <= 0 || k <= 0 || kk <= 0 ||
      kk > k || block_m <= 0 || n_blocks < 0 ||
      (global_carry && carry == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      global_carry ? 0
                   : sizeof(float) * kWalkWarps * (4 * (size_t)k + 2 * kk);
  gate_walk_kernel<<<(B + kWalkWarps - 1) / kWalkWarps, kWalkWarps * 32,
                     smem, (cudaStream_t)stream>>>(
      bounds, live, lvals, lids, tmax, vals, idx, stats,
      global_carry ? carry : nullptr, B, n_blocks, block_m, superblock, k,
      kk, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_mips_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
