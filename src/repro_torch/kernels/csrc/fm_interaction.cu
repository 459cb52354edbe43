// The FM second-order interaction (Rendle's sum-square identity), written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fm_interaction_pallas
// (src/repro/kernels/fm_interaction.py:26). For field embeddings
// emb [B, F, d] (fp32 or fp16) it computes
//
//   out[b] = 0.5 * sum_c [ (sum_f v[b, f, c])^2 - sum_f v[b, f, c]^2 ]
//
// in fp32 and writes the input's dtype. The order of operations is the
// reference's (the per-column difference s^2 - sq, then the sum over the
// columns, then the half), not a sum over field pairs: with fp16 inputs
// the pairwise form cancels badly.
//
// Design. The Pallas kernel reduces a [block_b, F, d] VMEM tile in one
// pass. Here one thread owns one (bag, column) pair: it walks the bag's F
// fields down its column and keeps both sums, s and sq, in fp32
// registers, so no [B, d] partial sum reaches device memory. A block holds
// floor(256 / d) whole bags (d threads each); each thread leaves s^2 - sq
// in shared memory and the bag's first thread adds its d columns in
// column order. Loads are issued 8 fields at a time before the adds.
//
// What bounds it on an H100: bytes. Every input value is read once (2 FLOPs
// per value for the sums), so the bound is the input's size over the
// memory rate: 409 MB at DeepFM's serve_bulk shape [262144, 39, 10] fp32.
// The threads of a bag read neighbouring values of one row of the bag per
// step, and the L1 serves the rest of each 128-byte line to the next steps.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 1024;      // one bag's columns fit one block
constexpr int kFieldBatch = 8;   // loads a thread issues before adding

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __half* p) {
  return __half2float(__ushort_as_half(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kMaxD)
fm_interaction_kernel(const T* __restrict__ emb, T* __restrict__ out, int B,
                      int F, int d, int bags_per_block) {
  __shared__ float part[kMaxD];
  const int local = threadIdx.x / d;
  const int c = threadIdx.x - local * d;
  const long long b = (long long)blockIdx.x * bags_per_block + local;
  const bool live = local < bags_per_block && b < B;
  float diff = 0.f;
  if (live) {
    const T* col = emb + b * F * d + c;
    float s = 0.f, sq = 0.f;
    for (int f0 = 0; f0 < F; f0 += kFieldBatch) {
      float v[kFieldBatch];
#pragma unroll
      for (int j = 0; j < kFieldBatch; ++j)
        v[j] = f0 + j < F ? load(col + (long long)(f0 + j) * d) : 0.f;
#pragma unroll
      for (int j = 0; j < kFieldBatch; ++j) {
        if (f0 + j < F) {
          s += v[j];
          sq += v[j] * v[j];
        }
      }
    }
    diff = s * s - sq;
  }
  part[threadIdx.x] = diff;
  __syncthreads();
  if (live && c == 0) {
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc += part[threadIdx.x + j];
    store(out + b, 0.5f * acc);
  }
}

}  // namespace

// emb [B, F, d] (fp32, or fp16 when `half`), out [B] in the input's dtype:
// contiguous on one device. Launches on `stream` and returns
// cudaGetLastError() (0 = the launch was accepted). The wrapper checks
// shapes and types, 1 <= d <= 1024, and returns before launching when
// B == 0.
extern "C" int fm_interaction_launch(const void* emb, void* out, int B, int F,
                                     int d, int half, void* stream) {
  const int bags = d >= kThreads ? 1 : kThreads / d;
  const unsigned grid = (unsigned)((B + bags - 1) / bags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half)
    fm_interaction_kernel<__half><<<grid, bags * d, 0, s>>>(
        static_cast<const __half*>(emb), static_cast<__half*>(out), B, F, d,
        bags);
  else
    fm_interaction_kernel<float><<<grid, bags * d, 0, s>>>(
        static_cast<const float*>(emb), static_cast<float*>(out), B, F, d,
        bags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fm_interaction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
