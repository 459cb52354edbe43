// Gather-fused scoring of scattered catalogue rows, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel gather_scores_pallas
// (src/repro/kernels/topk_mips.py:457). It computes what that kernel
// computes, for a batch of lanes at once:
//
//   out[b, c] = sum_r T[ids[b, c], r] * U[b, r]      (fp32)
//
// with T [M, R], ids [B, C] int32 (repeats allowed) and U [B, R]; the
// one-query form is B = 1. It is the tail scorer of the list engines:
// the candidates a Block Threshold Algorithm step enumerates past the
// contiguous list prefix are scattered rows of the catalogue, and the
// gathered [B, C, R] rows are never written to device memory.
//
// Design. A CUDA block serves one lane b (grid y) and 32 consecutive
// candidates of it (grid x). It stages U[b] in shared memory. Each of its
// 8 warps takes 4 candidates; the 32 lanes of a warp read a row's R floats
// at neighbouring addresses (R = 100 is three full 32-column chunks and a
// masked fourth), and all loads of a pass (4 rows x 4 chunks = 128
// columns) are issued before the first FMA, so a warp waits for memory
// once per 128 columns rather than once per chunk. A shuffle reduction
// finishes each row. An id outside [0, M) reads nothing and scores NaN,
// so a caller's out-of-range id shows in any comparison.
//
// What bounds it on an H100. Every candidate costs one row of R * 4 bytes
// (400 B at R = 100) and 2R FLOPs, so it is bytes-bound: at the main
// path's tail shape (B = 64 lanes, C = 25,600 candidates a lane, R = 100)
// the rows are 655 MB, 0.196 ms at 3.35 TB/s. Candidates repeat across
// lists and lanes, and the 50 MB L2 then serves a row more than once, so
// the measured time can fall below that count.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunks = 4;   // 32-column chunks loaded together per pass

__global__ void __launch_bounds__(kThreads)
gather_scores_kernel(const float* __restrict__ T, const int* __restrict__ ids,
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
      if (c < C) out[(size_t)b * C + c] = ok[q] ? acc[q] : __int_as_float(0x7fc00000);
    }
  }
}

}  // namespace

// T [M, R], ids [B, C] int32, U [B, R], out [B, C]: all contiguous on one
// device. Launches on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). The wrapper checks shapes, types, B <= 65535 (the
// grid's y limit) and R <= 4096 (U[b] in at most 16 KB of dynamic shared
// memory, under the 48 KB a launch may take without opting in).
extern "C" int gather_scores_launch(const float* T, const int* ids,
                                    const float* U, float* out, int B, int C,
                                    int M, int R, void* stream) {
  dim3 grid((C + kRowsPerBlock - 1) / kRowsPerBlock, B);
  gather_scores_kernel<<<grid, kThreads, sizeof(float) * (size_t)R,
                         static_cast<cudaStream_t>(stream)>>>(T, ids, U, out,
                                                              C, M, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
