// Gather-fused scoring of scattered catalogue rows, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel gather_scores_pallas
// (src/repro/kernels/topk_mips.py:457). It computes what that kernel
// computes, for a batch of lanes at once:
//
//   out[b, c] = sum_r T[ids[b, c], r] * U[b, r]      (fp32 FMAs, r in order)
//
// with T [M, R], ids [B, C] int32 (repeats allowed) and U [B, R]; the
// one-query form is B = 1. It is the tail scorer of the list engines:
// the candidates a Block Threshold Algorithm step enumerates past the
// contiguous list prefix are scattered rows of the catalogue, and the
// gathered [B, C, R] rows are never written to device memory. An id
// outside [0, M) reads nothing and scores NaN for its own (lane, column),
// whatever the other lanes of that column hold. No atomics: every output
// is one thread's sum, so the result does not depend on the grid's order.
//
// What bounds it on an H100. The function must read each distinct row
// once (with the ids, the queries and the output): bytes, 0.0096 ms at
// the main path's tail shape (B = 64 lanes, C = 25,600 candidates a lane,
// R = 100: 47,422 distinct rows, 19 MB). But each (lane, candidate) needs
// all R floats of its row in the lane's registers: 1,638,400 x 400 B =
// 655 MB. A block per lane reading each row from L2 runs at the L2's rate
// (0.176 ms cold on an H100); one thread per lane loading its row from
// global memory, even when the lanes of a warp share one address, runs at
// the L1 load pipe's instruction rate (0.137 ms cold on an H100, a first
// version of this kernel). All live lanes of a bta tail step share
// one block cursor, so column c = (list r, depth j) holds order_desc[r,
// d0 + j] for lanes with u_r >= 0 and order_desc[r, M-1-d0-j] for the
// rest: at most two distinct ids a column. The kernel does not assume
// that, but it makes it cheap.
//
// The lane path (B >= the wrapper's FEW_LANES). A persistent block walks
// tiles of G lanes (a power of two, 4 to 32) x CT columns; thread t serves
// lane t % G of 4 columns. Per tile it
//   - stages the ids tile [G][CT] (read coalesced along each lane's ids
//     row); each thread later writes its score over its own id, and the
//     tile goes back to `out` coalesced along each lane's row;
//   - gives each column two slots, lane 0's id and the first other lane's
//     (warp ballots), and stages the slots' rows in shared memory in
//     32-float chunks, copied with cp.async (16 bytes a copy where R % 4
//     == 0, 8 or 4 otherwise), double-buffered, so that chunk k + 1 is in
//     flight while chunk k is scored; the rows' later chunks are
//     prefetched into L2 first, so that each row leaves device memory at
//     once;
//   - stages the lanes' query chunk as [8][G][4], so that a lane reads 4
//     query values in one 16-byte shared load;
//   - scores: a lane reads its column's slot row with 16-byte shared
//     loads, which the lanes of a slot share as one broadcast, 8 FMAs per
//     pair of loads; an id in neither slot (only where a column holds
//     three or more ids) is read from global memory after the chunks.
// At the main tail shape this takes 0.070 ms cold on an H100.
//
// The row path (few lanes: the 1-D form and the late tail steps, when the
// lane path's tiles would be mostly idle): a block per lane (grid y) and
// 32 consecutive candidates; each of its 8 warps takes 4 rows, its 32
// threads across a row's columns, all loads of a 128-column pass issued
// before the first FMA, a shuffle reduction per row. The wrapper picks the
// path by shape; neither is taken because the other failed.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// ---- the row path ----------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunks = 4;   // 32-column chunks loaded together per pass

__global__ void __launch_bounds__(kThreads)
gather_scores_rows_kernel(const float* __restrict__ T,
                          const int* __restrict__ ids,
                          const float* __restrict__ U, float* __restrict__ out,
                          int C, int M, int R) {
  extern __shared__ float u[];
  const int b = blockIdx.y;
  const float* ub = U + (size_t)b * R;
  for (int i = threadIdx.x; i < R; i += kThreads) u[i] = ub[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int* idb = ids + (size_t)b * C;

  int id[kRowsPerWarp];
  bool ok[kRowsPerWarp];
  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int c = c0 + q;
    id[q] = c < C ? __ldg(idb + c) : 0;
    ok[q] = c < C && id[q] >= 0 && id[q] < M;
    acc[q] = 0.f;
  }

  for (int base = 0; base < R; base += 32 * kChunks) {
    float v[kRowsPerWarp][kChunks];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const float* row = T + (size_t)(ok[q] ? id[q] : 0) * R;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int col = base + 32 * j + lane;
        v[q][j] = (ok[q] && col < R) ? __ldg(row + col) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = base + 32 * j + lane;
      const float uj = col < R ? u[col] : 0.f;
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = fmaf(v[q][j], uj, acc[q]);
    }
  }

#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int c = c0 + q;
      if (c < C) out[(size_t)b * C + c] = ok[q] ? acc[q] : nan_f();
    }
  }
}

// ---- the lane path ---------------------------------------------------------

constexpr int kCols = 4;     // columns a thread serves
constexpr int kRC = 32;      // floats of a row staged a chunk
constexpr int kRS = kRC + 4; // staged row stride: two rows of a column, and
                             // the rows of a warp's columns, on distinct banks

// Asynchronous copies into shared memory (cp.async, sm_80+): N = 16
// bypasses L1; 4- and 8-byte copies go through it.
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dot8(float4 xa, float4 xb, float4 ua,
                                      float4 ub, float acc) {
  acc = fmaf(xa.x, ua.x, acc);
  acc = fmaf(xa.y, ua.y, acc);
  acc = fmaf(xa.z, ua.z, acc);
  acc = fmaf(xa.w, ua.w, acc);
  acc = fmaf(xb.x, ub.x, acc);
  acc = fmaf(xb.y, ub.y, acc);
  acc = fmaf(xb.z, ub.z, acc);
  return fmaf(xb.w, ub.w, acc);
}

// A persistent block walks tiles of G lanes x CT columns, with CT * G / 4
// threads (thread t serves lane t % G of 4 columns). Shared memory, in
// words:
//   rows_s [2][CT][2][kRS]    the slots' row chunks, double-buffered
//   u_s    [2][kRC/4][G][4]   the lanes' query chunk, likewise
//   tile   [G][CT + 32 / G]   ids in, scores out
//   slot   [CT][2]            a column's two staged ids (-1: none)
// V is the width of a row's global loads (the staging copies); shared
// reads are 16 bytes. Four blocks an SM (at most 64 registers a thread):
// on an H100 the resident warps hide the staging better than the
// registers they cost.
template <int V>
__global__ void __launch_bounds__(256, 4)
gather_scores_lanes_kernel(const float* __restrict__ T,
                           const int* __restrict__ ids,
                           const float* __restrict__ U,
                           float* __restrict__ out, int B, int C, int M,
                           int R, int G, int CT) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;
  const int S = CT + 32 / G;                 // ids row stride: bank-free
  float* rows_s = smem;                      // 16-byte aligned first
  float* u_s = rows_s + 2 * 2 * CT * kRS;
  float* tile = u_s + 2 * kRC * G;
  int* slot = reinterpret_cast<int*>(tile + G * S);
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid & (G - 1);
  const int sub = tid / G;
  const int pass = nt / G;                   // columns a pass of the block
  const int col_tiles = (int)(((long long)C + CT - 1) / CT);
  const long long n_tiles = (long long)col_tiles * ((B + G - 1) / G);

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b0 = (int)(t / col_tiles) * G;
    const long long c0 = (t % col_tiles) * CT;
    const int nb = min(G, B - b0);
    const int nc = (int)min((long long)CT, (long long)C - c0);
    const bool lane_ok = g < nb;
    if (t != blockIdx.x) __syncthreads();    // the last tile is written out

    for (int i = tid; i < nb * nc; i += nt) {  // coalesced along lane rows
      const int gg = i / nc, ct = i - gg * nc;
      tile[gg * S + ct] = __int_as_float(
          __ldg(ids + (size_t)(b0 + gg) * C + c0 + ct));
    }
    __syncthreads();

    // A column's slots: lane 0's id and the first other lane's; a warp
    // takes 32 / G columns at a time, G lanes each.
    {
      const int per = 32 / G, sg = lane / G, gl = lane & (G - 1);
      const unsigned seg =
          (G == 32 ? 0xffffffffu : ((1u << G) - 1)) << (sg * G);
      for (int ct0 = (tid >> 5) * per; ct0 < CT; ct0 += (nt >> 5) * per) {
        const int ct = ct0 + sg;
        const bool live = ct < nc && gl < nb;
        const int v = live ? __float_as_int(tile[gl * S + ct]) : -1;
        const int a = __shfl_sync(0xffffffffu, v, sg * G);
        const unsigned other =
            __ballot_sync(0xffffffffu, live && v != a) & seg;
        const int b =
            __shfl_sync(0xffffffffu, v, other ? __ffs(other) - 1 : 0);
        if (gl == 0) {
          slot[2 * ct] = (a >= 0 && a < M) ? a : -1;
          slot[2 * ct + 1] = (other && b >= 0 && b < M) ? b : -1;
        }
      }
    }
    __syncthreads();

    // stage chunk r0 of the slots' rows (each contiguous, copied
    // coalesced) and of the lanes' queries into buffer `buf`; past the
    // row's end both are zero
    auto stage = [&](int r0, int buf) {
      const int rc = min(kRC, R - r0);
      const int rc8 = (rc + 7) & ~7;
      float* rb = rows_s + buf * 2 * CT * kRS;
      for (int i = tid; i < 2 * CT * (rc8 / V); i += nt) {
        const int row = i / (rc8 / V), q = (i - row * (rc8 / V)) * V;
        const int sid = slot[row];
        if (sid < 0) continue;
        if (q < rc)
          cp_async<4 * V>(rb + row * kRS + q, T + (size_t)sid * R + r0 + q);
        else
#pragma unroll
          for (int v = 0; v < V; ++v) rb[row * kRS + q + v] = 0.f;
      }
      float* ub = u_s + buf * kRC * G;
      for (int i = tid; i < nb * rc8; i += nt) {
        const int gg = i / rc8, r = i - gg * rc8;
        float* dst = ub + ((r >> 2) * G + gg) * 4 + (r & 3);
        if (r < rc)
          cp_async<4>(dst, U + (size_t)(b0 + gg) * R + r0 + r);
        else
          *dst = 0.f;
      }
      cp_async_commit();
    };
    stage(0, 0);
    // the later chunks of every slot row into L2 now, so that a row is
    // read from device memory at once rather than a chunk at a time
    const int lines = (R + 31) / 32;         // 128-byte pieces of a row
    for (int i = tid; i < 2 * CT * (lines - 1); i += nt) {
      const int row = i / (lines - 1), l = 1 + i - row * (lines - 1);
      const int sid = slot[row];
      if (sid >= 0)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            T + (size_t)sid * R + 32 * l));
    }

    int id[kCols], off[kCols];
    bool direct = false;                     // an id in neither slot
#pragma unroll
    for (int p = 0; p < kCols; ++p) {
      const int ct = sub + p * pass;
      id[p] = (lane_ok && ct < nc) ? __float_as_int(tile[g * S + ct]) : -1;
      const bool ok = id[p] >= 0 && id[p] < M;
      const bool s1 = ok && id[p] != slot[2 * ct] && id[p] == slot[2 * ct + 1];
      direct |= ok && id[p] != slot[2 * ct] && !s1;
      off[p] = (2 * ct + s1) * kRS;
    }
    float acc[kCols] = {};

    for (int r0 = 0, buf = 0; r0 < R; r0 += kRC, buf ^= 1) {
      const int rc8 = (min(kRC, R - r0) + 7) & ~7;
      if (r0 + kRC < R) {                    // the next chunk in flight
        stage(r0 + kRC, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                       // chunk r0 has landed
      const float* rb = rows_s + buf * 2 * CT * kRS;
      const float4* ub = reinterpret_cast<const float4*>(u_s + buf * kRC * G);
      for (int j0 = 0; j0 < rc8; j0 += 8) {
        const float4 ua = ub[(j0 >> 2) * G + g];
        const float4 uv = ub[((j0 >> 2) + 1) * G + g];
#pragma unroll
        for (int p = 0; p < kCols; ++p) {
          const float4* x = reinterpret_cast<const float4*>(rb + off[p] + j0);
          acc[p] = dot8(x[0], x[1], ua, uv, acc[p]);
        }
      }
      __syncthreads();                       // buffer `buf` is free again
    }

    if (direct) {                            // rare: read such rows directly
#pragma unroll
      for (int p = 0; p < kCols; ++p) {
        const int ct = sub + p * pass;
        if (id[p] < 0 || id[p] >= M || id[p] == slot[2 * ct] ||
            id[p] == slot[2 * ct + 1])
          continue;
        const float* row = T + (size_t)id[p] * R;
        const float* u = U + (size_t)(b0 + g) * R;
        float a = 0.f;
        for (int r = 0; r < R; ++r) a = fmaf(__ldg(row + r), __ldg(u + r), a);
        acc[p] = a;
      }
    }
#pragma unroll
    for (int p = 0; p < kCols; ++p) {
      const int ct = sub + p * pass;
      if (lane_ok && ct < nc)
        tile[g * S + ct] = (id[p] >= 0 && id[p] < M) ? acc[p] : nan_f();
    }
    __syncthreads();
    for (int i = tid; i < nb * nc; i += nt) {
      const int gg = i / nc, ct = i - gg * nc;
      out[(size_t)(b0 + gg) * C + c0 + ct] = tile[gg * S + ct];
    }
  }
}

// The SMs of the current device into *n, read once a device after the
// first: a launch makes no other host call than itself. Returns the CUDA
// error of a failed query.
cudaError_t sm_count(int* n) {
  static int counts[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    e = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *n = counts[dev];
  return cudaSuccess;
}

template <int V>
int launch_lanes(const float* T, const int* ids, const float* U, float* out,
                 int B, int C, int M, int R, int G, int CT, int smem,
                 cudaStream_t s) {
  // as many blocks as the card holds at once: __launch_bounds__(256, 4)
  // and at most 48 KB a block give 1,024 threads an SM
  const int threads = CT * G / kCols;
  const long long tiles =
      (((long long)C + CT - 1) / CT) * ((B + G - 1) / G);
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = (long long)sms * (1024 / threads);
  gather_scores_lanes_kernel<V>
      <<<(unsigned)(tiles < resident ? tiles : resident), threads, smem, s>>>(
          T, ids, U, out, B, C, M, R, G, CT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// T [M, R], ids [B, C] int32, U [B, R], out [B, C]: all contiguous on one
// device. Each function launches on `stream` and returns
// cudaGetLastError() (0 = the launch was accepted). The wrapper
// (kernels/gather_scores.py: launch_plan) picks the path, checks shapes,
// types and limits, and works out G, V and the shared-memory bytes.

// The row path: a block per lane and 32 candidates; R * 4 bytes of
// dynamic shared memory (R <= 4096), B <= 65535 (the grid's y limit).
extern "C" int gather_scores_rows_launch(const float* T, const int* ids,
                                         const float* U, float* out, int B,
                                         int C, int M, int R, void* stream) {
  dim3 grid((C + kRowsPerBlock - 1) / kRowsPerBlock, B);
  gather_scores_rows_kernel<<<grid, kThreads, sizeof(float) * (size_t)R,
                              static_cast<cudaStream_t>(stream)>>>(
      T, ids, U, out, C, M, R);
  return static_cast<int>(cudaGetLastError());
}

// The lane path: tiles of G lanes (a power of two, 4 to 32) x CT columns
// (CT * G / 4 threads a block: 32 to 256), walked by as many persistent
// blocks as the card holds at once; `vec` floats a global load (4, 2 or 1:
// R and T's address must allow it); `smem` = 4 * (4 * CT * 36 + 64 * G +
// G * (CT + 32 / G) + 2 * CT) bytes, at most 48 KB.
extern "C" int gather_scores_lanes_launch(const float* T, const int* ids,
                                          const float* U, float* out, int B,
                                          int C, int M, int R, int G,
                                          int vec, int CT, int smem,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      return launch_lanes<4>(T, ids, U, out, B, C, M, R, G, CT, smem, s);
    case 2:
      return launch_lanes<2>(T, ids, U, out, B, C, M, R, G, CT, smem, s);
    case 1:
      return launch_lanes<1>(T, ids, U, out, B, C, M, R, G, CT, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gather_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
