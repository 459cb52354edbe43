// Exact top-K maximum-inner-product scan over a norm-sorted catalogue,
// written for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of repro/kernels/topk_mips.py:
//   topk_mips_pallas_batched_prefetch  -> mode TWO_LEVEL_BATCHED
//   topk_mips_pallas_prefetch          -> mode TWO_LEVEL_TILE
//   topk_mips_pallas, topk_mips_pallas_batched -> mode SINGLE_LEVEL
// It computes what they compute: per query, walk the catalogue tiles
// (block_m rows each, decreasing-norm order) and, for every tile whose
// Cauchy-Schwarz bound ||u||*max_norm(tile) is STRICTLY above the running
// K-th best, score the tile and merge it into the carried top-K. Rows at or
// past num_real are zero padding and score NEG_INF (-1e30). Output per
// query: values [k], local row ids [k] and stats [3] = (rows scored,
// tiles visited, tiles loaded), column for column as the reference.
//
// Design. The Pallas kernels carry the top-K in VMEM scratch across a
// sequential grid. Nothing carries between CUDA blocks, so ONE CUDA BLOCK
// OWNS ONE QUERY and walks that query's tiles in order in a loop. The loop
// bound is the query's live-tile count from the host pre-screen: rows past
// the live prefix are never read (the GPU form of the scalar-prefetch DMA
// skip). Scoring gives each warp 8 rows at a time, lanes striding over R
// with scalar fp32 loads (no 16-byte alignment assumed: R is 100, 50 or
// 17); all loads of a pass (8 rows x up to 128 columns) are issued before
// the first FMA, so a 256-row tile costs two round trips to memory, and a
// shuffle reduction finishes each row. The merge keeps the top-K in
// shared memory: only tile rows scoring strictly above the K-th best can
// enter (the carry wins ties, and its rows are all lower), they are
// compacted, and every element's merged rank is counted directly. The order
// is (value descending, row ascending), which is the reference's
// "carry wins ties" plus lax.top_k's "lower index wins".
//
// What bounds it on an H100. Each query re-reads its own live prefix, so
// the bytes moved are about B x live rows x R x 4. At B = 64 over the full
// 325,056 x 100 LSHTC-like catalogue that is ~8 GB a batch, far past the
// 50 MB L2 and 3.35 TB/s of HBM, and one block per query leaves 68 of the
// 132 SMs idle at B = 64. The next design shares each tile load across the
// batch (as the `norm` engine's [B,R]@[R,block] step already does) and
// stages tiles with TMA into a ring of shared-memory buffers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kChunks = 4;   // 32-column chunks loaded together: R <= 128
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 48 * 1024;

enum Mode { TWO_LEVEL_BATCHED = 0, TWO_LEVEL_TILE = 1, SINGLE_LEVEL = 2 };

size_t smem_bytes(int R, int block_m, int k) {
  // u[R], scores[block_m], cand_vals[block_m], cand_rows[block_m],
  // carry vals/ids [k] and the merge's next vals/ids [k]
  return sizeof(float) * (size_t)(R + 3 * block_m + 4 * k);
}

__global__ void __launch_bounds__(kThreads)
topk_mips_kernel(const float* __restrict__ T, const float* __restrict__ U,
                 const float* __restrict__ bounds,
                 const int* __restrict__ live, float* __restrict__ out_vals,
                 int* __restrict__ out_idx, int* __restrict__ out_stats,
                 int R, int n_blocks, int block_m, int superblock, int k,
                 int num_real, int mode) {
  extern __shared__ float smem[];
  float* u = smem;
  float* sc = u + R;
  float* cand_v = sc + block_m;
  int* cand_r = reinterpret_cast<int*>(cand_v + block_m);
  float* cv = reinterpret_cast<float*>(cand_r + block_m);
  int* ci = reinterpret_cast<int*>(cv + k);
  float* nv = reinterpret_cast<float*>(ci + k);
  int* ni = reinterpret_cast<int*>(nv + k);
  __shared__ int n_cand;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* ub = U + (size_t)b * R;
  for (int r = tid; r < R; r += kThreads) u[r] = ub[r];
  for (int j = tid; j < k; j += kThreads) {
    cv[j] = kNegInf;
    ci[j] = -1;
  }
  int n_tiles = n_blocks;                               // SINGLE_LEVEL
  if (mode == TWO_LEVEL_TILE) n_tiles = live[b];        // live tiles
  if (mode == TWO_LEVEL_BATCHED) n_tiles = live[b] * superblock;
  n_tiles = min(max(n_tiles, 0), n_blocks);
  __syncthreads();

  const float* brow = bounds + (size_t)b * n_blocks;
  int scored = 0;
  int visited = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const float lb = cv[k - 1];
    // uniform across the block: every thread reads the same two values
    if (!(brow[t] > lb)) continue;
    scored += block_m;
    visited += 1;
    const int row0 = t * block_m;
    const float* tile = T + (size_t)row0 * R;

    for (int i0 = warp * kRowsPerWarp; i0 < block_m;
         i0 += kWarps * kRowsPerWarp) {
      float acc[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) acc[j] = 0.f;
      for (int r0 = lane; r0 < R; r0 += 32 * kChunks) {
        // every load of the pass is issued before the first FMA waits on
        // one: one round trip to memory per pass, not one per column chunk
        float x[kChunks][kRowsPerWarp];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int r = r0 + 32 * c;
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j)
            x[c][j] = (r < R && i0 + j < block_m)
                          ? __ldg(tile + (size_t)(i0 + j) * R + r) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int r = r0 + 32 * c;
          const float ur = r < R ? u[r] : 0.f;
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j)
            acc[j] = fmaf(x[c][j], ur, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        float a = acc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        const int i = i0 + j;
        if (lane == 0 && i < block_m)
          sc[i] = (row0 + i < num_real) ? a : kNegInf;
      }
    }
    if (tid == 0) n_cand = 0;
    __syncthreads();

    // only rows strictly above the K-th best can enter the carry
    for (int i = tid; i < block_m; i += kThreads) {
      const float s = sc[i];
      if (s > lb) {
        const int p = atomicAdd(&n_cand, 1);
        cand_v[p] = s;
        cand_r[p] = row0 + i;
      }
    }
    __syncthreads();
    const int c = n_cand;
    if (c > 0) {
      // carry entry j keeps its rank among the carry and moves down past
      // every candidate that beats it strictly (the carry wins ties)
      for (int j = tid; j < k; j += kThreads) {
        const float v = cv[j];
        int pos = j;
        for (int q = 0; q < c; ++q) pos += (cand_v[q] > v);
        if (pos < k) {
          nv[pos] = v;
          ni[pos] = ci[j];
        }
      }
      // a candidate ranks after every carry entry >= it (binary search in
      // the descending carry) and after every candidate ahead of it in
      // (value descending, row ascending) order
      for (int q = tid; q < c; q += kThreads) {
        const float s = cand_v[q];
        const int r = cand_r[q];
        int lo = 0, hi = k;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cv[mid] >= s) lo = mid + 1; else hi = mid;
        }
        int pos = lo;
        for (int p = 0; p < c && pos < k; ++p) {
          const float s2 = cand_v[p];
          pos += (s2 > s) || (s2 == s && cand_r[p] < r);
        }
        if (pos < k) {
          nv[pos] = s;
          ni[pos] = r;
        }
      }
      __syncthreads();
      for (int j = tid; j < k; j += kThreads) {
        cv[j] = nv[j];
        ci[j] = ni[j];
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < k; j += kThreads) {
    out_vals[(size_t)b * k + j] = cv[j];
    out_idx[(size_t)b * k + j] = ci[j];
  }
  if (tid == 0) {
    out_stats[b * 3 + 0] = scored;
    out_stats[b * 3 + 1] = visited;
    out_stats[b * 3 + 2] = n_tiles;
  }
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. Returns the
// cudaError_t of the launch (0 = launched); `live` may be null in
// SINGLE_LEVEL mode. Launches on `stream` and does not synchronise.
extern "C" int topk_mips_launch(const float* T, const float* U,
                                const float* bounds, const int* live,
                                float* vals, int* idx, int* stats, int B,
                                int R, int n_blocks, int block_m,
                                int superblock, int k, int num_real, int mode,
                                void* stream) {
  const size_t smem = smem_bytes(R, block_m, k);
  if (smem > kMaxSmem || mode < 0 || mode > SINGLE_LEVEL || B <= 0 ||
      k <= 0 || block_m <= 0)
    return (int)cudaErrorInvalidValue;
  topk_mips_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      T, U, bounds, live, vals, idx, stats, R, n_blocks, block_m, superblock,
      k, num_real, mode);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_mips_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
