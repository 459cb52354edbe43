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
// accumulating in fp32 in field order, dividing by F in fp32 before the
// cast, and writing the table's dtype once, as the Pallas kernel does.
// The gathered [B, F, d] rows are never written to device memory. An id
// in [-V, 0) counts from the end of the table and any id outside [-V, V)
// reads nothing and makes its bag NaN: jnp.take's behaviour, which the
// reference's oracle and models use. The recsys model runs it twice per
// batch: the first-order term (sum over the linear weights viewed as a
// [V, 1] table) and the query tower (mean, d = 10 at DeepFM's width).
//
// What bounds it on an H100. The function must read the ids (4BF bytes),
// each distinct row once, and write the output: bytes. With the zipf ids
// of a click log most (bag, field) rows repeat, and the 50 MB L2 serves
// the repeats; but every gather still costs L1 and L2 a 32-byte sector:
// 10.2M gathers x 32 B ~ 327 MB at serve_bulk's 262,144 x 39 ids (d = 1),
// and about twice the sectors at d = 10, whose 40-byte rows straddle
// sectors. On an H100 both run near one sector an SM a clock (0.056 ms
// for d = 1, 0.133 ms for d = 10), so the sectors a gather touches, not
// the bytes it needs, set the time.
//
// Two paths, by shape:
//
// d = 1, a lane per bag. A thread that owns one bag reads that bag's F
// ids, strided F * 4 bytes across a warp (32 sectors for 128 useful
// bytes), and has only a few gathers in flight. Here each warp's task is
// 32 consecutive bags: the warp copies their ids, one contiguous [32, F]
// slab (16-byte cp.async copies, or F-field chunks of odd-length rows when
// F is even or large), into its own shared buffer, then each lane gathers
// its bag's values 8 fields at a time and adds them in field order. A
// warp's 32 lanes read the same field at once, so the zipf-hot rows of
// that field repeat within a load instruction and in L1. The warps walk
// tasks alone (no block barrier), with a stride of all the grid's warps,
// as many as the card holds at once; each warp copies its next chunk's ids
// while it gathers the current one (two buffers).
//
// d > 1, a thread per (bag, column) output: the d threads of a bag read
// its row's d neighbouring values, and read the bag's ids through L1 (one
// broadcast load per field). Staging those ids in shared memory as at
// d = 1 was slower at d = 10 in every variant tried (a first version that
// staged the ids and the gathered values: 0.188 ms against 0.133 ms on an
// H100): it removes no row sector, and its copies, barriers and registers
// cost the gather occupancy.
//
// Addresses are 64-bit: at DLRM-RM2's width row * d reaches 1.7e9.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;   // gathers a thread has in flight at once

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __half* p) {
  return __half2float(__ushort_as_half(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// ---- d > 1: a thread per (bag, column) -------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_cols_kernel(const T* __restrict__ table,
                          const int* __restrict__ ids, T* __restrict__ out,
                          long long B, int F, int V, int d, int mean) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= B * d) return;
  const long long b = t / d;
  const int c = (int)(t - b * d);
  const int* idb = ids + b * F;
  const float nan = __int_as_float(0x7fc00000);
  float acc = 0.f;
  for (int f0 = 0; f0 < F; f0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      v[j] = 0.f;
      if (f0 + j < F) {
        const int id = __ldg(idb + f0 + j);
        const long long row = id < 0 ? (long long)id + V : (long long)id;
        v[j] = (row >= 0 && row < V) ? load(table + row * d + c) : nan;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (f0 + j < F) acc += v[j];
  }
  if (mean) acc = acc / (float)F;
  store(out + t, acc);
}

// ---- d = 1: a lane per bag, the ids staged a warp at a time ----------------

// Asynchronous copies into shared memory (cp.async, sm_80+).
template <int N>
__device__ __forceinline__ void cp_async(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether a chunk is a contiguous slab (every field, odd F), and where its
// ids start in the buffer: at the source's word offset in 16 bytes, so
// that its aligned words copy 16 bytes at a time.
__device__ __forceinline__ bool is_slab(int F, int fc) {
  return fc == F && (F & 1);
}
__device__ __forceinline__ int slab_shift(const int* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// the ids of fields [f0, f0 + fc) of bags [b0, b0 + nb) into `buf`, one
// row of fc | 1 words a bag (odd, so that a warp's bags read distinct
// banks), as the calling warp's cp.async copies of one commit group
__device__ __forceinline__ void stage_ids(int* buf, const int* ids,
                                          long long b0, int nb, int F, int f0,
                                          int fc, int lane) {
  const int n = nb * fc;
  const int* src = ids + b0 * F + f0;
  if (!is_slab(F, fc)) {
    const int stride = fc | 1;
    for (int i = lane; i < n; i += 32) {
      const int bag = i / fc, f = i - bag * fc;
      cp_async<4>(buf + bag * stride + f, src + (long long)bag * F + f);
    }
  } else {
    int* dst = buf + slab_shift(src);
    const int head = min(n, (4 - slab_shift(src)) & 3);
    if (lane < head) cp_async<4>(dst + lane, src + lane);
    const int n4 = (n - head) >> 2;
    for (int i = lane; i < n4; i += 32)
      cp_async<16>(dst + head + 4 * i, src + head + 4 * i);
    for (int i = head + 4 * n4 + lane; i < n; i += 32)
      cp_async<4>(dst + i, src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// `buf_words` is one of a warp's two buffers; the caller guarantees F > 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_bags_kernel(const T* __restrict__ table,
                          const int* __restrict__ ids, T* __restrict__ out,
                          int B, int F, int V, int FC, int buf_words,
                          int mean) {
  extern __shared__ __align__(16) int ids_s[];
  const int lane = threadIdx.x & 31;
  int* wbuf = ids_s + (threadIdx.x >> 5) * 2 * buf_words;
  const int n_tasks = (B + 31) / 32;
  const int n_chunks = (F + FC - 1) / FC;
  const int step = gridDim.x * kWarps;
  const float nan = __int_as_float(0x7fc00000);

  auto stage = [&](int task, int c, int buf) {
    const long long b0 = 32LL * task;
    stage_ids(wbuf + buf * buf_words, ids, b0, min(32, B - (int)b0), F,
              c * FC, min(FC, F - c * FC), lane);
  };
  int t = blockIdx.x * kWarps + (threadIdx.x >> 5), c = 0, buf = 0;
  if (t < n_tasks) stage(t, 0, 0);
  float acc = 0.f;
  while (t < n_tasks) {
    int tn = t, cn = c + 1;                 // the warp's next step
    if (cn == n_chunks) {
      cn = 0;
      tn += step;
    }
    if (tn < n_tasks) {
      stage(tn, cn, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();                           // this chunk's ids have landed

    const long long b0 = 32LL * t;
    const int bag = (int)b0 + lane;
    const int f0 = c * FC, fc = min(FC, F - f0);
    if (bag < B) {
      const int* src = ids + b0 * F + f0;
      const int* my = wbuf + buf * buf_words +
                      (is_slab(F, fc) ? slab_shift(src) : 0) +
                      lane * (fc | 1);
      for (int f = 0; f < fc; f += kBatch) {
        // kBatch gathers in flight, then their sum in field order
        float v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          v[j] = 0.f;
          if (f + j < fc) {
            const int id = my[f + j];
            const long long row = id < 0 ? (long long)id + V : (long long)id;
            v[j] = (row >= 0 && row < V) ? load(table + row) : nan;
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (f + j < fc) acc += v[j];
      }
      if (c == n_chunks - 1) {
        if (mean) acc = acc / (float)F;
        store(out + bag, acc);
      }
    }
    if (c == n_chunks - 1) acc = 0.f;
    __syncwarp();                           // buffer `buf` is free again
    t = tn;
    c = cn;
    buf ^= 1;
  }
}

template <typename T>
int launch(const void* table, const int* ids, void* out, int B, int F, int V,
           int d, int bags, int FC, int buf_words, int mean, cudaStream_t s) {
  if (!bags) {
    const long long n = (long long)B * d;
    embedding_bag_cols_kernel<T>
        <<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            static_cast<const T*>(table), ids, static_cast<T*>(out), B, F, V,
            d, mean);
    return static_cast<int>(cudaGetLastError());
  }
  // as many blocks as the card holds at once, or the tasks' warps if fewer;
  // the SM count and the blocks an SM holds are read once
  auto kernel = embedding_bag_bags_kernel<T>;
  const int smem = 8 * kWarps * buf_words;
  static int sms = 0, per_sm = 0, per_sm_smem = -1;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (per_sm_smem != smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm_smem = smem;
  }
  const long long want = ((B + 31) / 32 + kWarps - 1) / kWarps;
  const long long resident = (long long)max(per_sm, 1) * sms;
  kernel<<<(unsigned)(want < resident ? want : resident), kThreads, smem,
           s>>>(static_cast<const T*>(table), ids, static_cast<T*>(out), B,
                F, V, FC, buf_words, mean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [V, d] (fp32, or fp16 when `half`), ids [B, F] int32, out [B, d]
// in the table's dtype: all contiguous on one device. `mean` != 0 divides
// by F. The wrapper (kernels/embedding_bag.py: launch_plan) picks the
// path: `bags` != 0, only for d = 1 and F > 0, takes the lane-per-bag
// path with FC fields a chunk and buf_words words in each of a warp's two
// ids buffers (at least 32 * (FC | 1) + 3, a multiple of 4; a block of 8
// warps takes 64 * buf_words bytes of dynamic shared memory); otherwise a
// thread per output, and FC and buf_words are not read. Launches on
// `stream` and returns
// cudaGetLastError() (0 = the launch was accepted). The wrapper returns
// before launching when B * d == 0.
extern "C" int embedding_bag_launch(const void* table, const int* ids,
                                    void* out, int B, int F, int V, int d,
                                    int mean, int half, int bags, int FC,
                                    int buf_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return half ? launch<__half>(table, ids, out, B, F, V, d, bags, FC,
                               buf_words, mean, s)
              : launch<float>(table, ids, out, B, F, V, d, bags, FC,
                              buf_words, mean, s);
}

extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
