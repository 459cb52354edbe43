// Fixed-arity EmbeddingBag (the sum or mean of table rows per bag),
// written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel embedding_bag_pallas
// (src/repro/kernels/embedding_bag.py:47). For a table [V, d] (fp32 or
// fp16) and ids [B, F] int32 it computes
//
//   out[b, c] = sum_f table[ids[b, f], c]          (mode sum)
//   out[b, c] = (sum_f table[ids[b, f], c]) / F    (mode mean)
//
// accumulating in fp32, dividing by F in fp32 before the cast, and writing
// the table's dtype, as the Pallas kernel does. The gathered [B, F, d]
// rows are never written to device memory. An id in [-V, 0) counts from
// the end of the table and any id outside [-V, V) reads nothing and makes
// its bag NaN: jnp.take's behaviour, which the reference's oracle and
// models use. The recsys model runs it twice per batch: the query tower
// (mean, d = 10 at DeepFM's width) and the first-order term (sum over the
// linear weights viewed as a [V, 1] table).
//
// Design. The Pallas kernel walks the bags of a block in a sequential
// loop, one row DMA per (bag, field). Here one thread owns one (bag,
// column) pair of the flattened [B, d] output, so narrow rows (d = 10,
// d = 1) still fill every lane of a warp: the d threads of a bag read its
// row's d neighbouring values, and the ids of a bag are one broadcast
// load. A thread loads the ids of 8 fields, then the 8 values, before it
// adds them in field order, so 8 gathers per thread are in flight at a
// time. Row addresses are 64-bit: at DLRM-RM2's width row * d reaches
// 1.7e9.
//
// What bounds it on an H100: bytes. The function must read the ids (4BF
// bytes), each distinct row once and write the output; with the zipf ids
// of a click log most (bag, field) rows repeat, and the 50 MB L2 serves
// the repeats.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFieldBatch = 8;   // gathers a thread issues before adding

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
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     T* __restrict__ out, long long B, int F, int V, int d,
                     int mean) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= B * d) return;
  const long long b = t / d;
  const int c = (int)(t - b * d);
  const int* idb = ids + b * F;
  const float nan = __int_as_float(0x7fc00000);
  float acc = 0.f;
  for (int f0 = 0; f0 < F; f0 += kFieldBatch) {
    float v[kFieldBatch];
#pragma unroll
    for (int j = 0; j < kFieldBatch; ++j) {
      v[j] = 0.f;
      if (f0 + j < F) {
        const int id = __ldg(idb + f0 + j);
        const long long row = id < 0 ? (long long)id + V : (long long)id;
        v[j] = (row >= 0 && row < V) ? load(table + row * d + c) : nan;
      }
    }
#pragma unroll
    for (int j = 0; j < kFieldBatch; ++j)
      if (f0 + j < F) acc += v[j];
  }
  if (mean) acc = acc / (float)F;
  store(out + t, acc);
}

}  // namespace

// table [V, d] (fp32, or fp16 when `half`), ids [B, F] int32, out [B, d]
// in the table's dtype: all contiguous on one device. `mean` != 0 divides
// by F. Launches on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). The wrapper checks shapes and types and returns
// before launching when B * d == 0.
extern "C" int embedding_bag_launch(const void* table, const int* ids,
                                    void* out, int B, int F, int V, int d,
                                    int mean, int half, void* stream) {
  const long long n = (long long)B * d;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half)
    embedding_bag_kernel<__half><<<grid, kThreads, 0, s>>>(
        static_cast<const __half*>(table), ids, static_cast<__half*>(out), B,
        F, V, d, mean);
  else
    embedding_bag_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(table), ids, static_cast<float*>(out), B,
        F, V, d, mean);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
