// hash_combine.cu — the Mapper's combiner (bucket accumulation by key) as
// one hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/hash_combine/kernel.py::_hash_combine_kernel, the
// Pallas TPU kernel behind combine_fn="pallas".  It computes the same
// function: out[b, d] = sum over rows n with keys[n] == b and valid[n] of
// values[n, d], for b in [0, B).  A key outside [0, B) matches no bucket
// and is dropped; an invalid row is skipped (never multiplied by zero, so
// a NaN in it cannot reach the sum).  Values are float32 or bfloat16; the
// sum is taken in float32 and written once in the values' dtype.
//
// Design.  The TPU kernel builds a (block_n x B) one-hot and multiplies it
// into the values on the MXU, because the TPU has no fast scatter.  Hopper
// has fast shared-memory and L2 atomics, so the combine is a scatter:
//   * B*D*4 bytes <= kSharedLimit: each block zeroes a private float32
//     copy of the (B, D) accumulator in shared memory (dynamic, above
//     48 KB only after cudaFuncAttributeMaxDynamicSharedMemorySize), runs
//     a grid-stride loop over records doing shared atomicAdd, then adds
//     each nonzero cell of its copy to the global accumulator with one
//     global atomicAdd.  The grid is one full wave (as many blocks as fit
//     on the SMs at once), so each record is read once and the global
//     flush costs (blocks x B x D) atomics at most.
//   * above that size: the same loop with atomicAdd straight into the
//     global accumulator.  Which path runs is the kernel's own choice by
//     size, not a fallback.
//   * bfloat16 values accumulate into a float32 scratch that a second,
//     elementwise kernel rounds into the output once.
// Float atomics change the order of the sums: integer-valued float32 sums
// below 2^24 are exact in any order, so on such data the result is
// bit-identical to the plain version.
//
// What bounds it on an H100.  Each record is read once: 4 B of key, 1 B of
// valid flag and 4*D (or 2*D) B of values, so at the batch word count's
// shape (2^28 records, D = 1, B = 1000: a 4 KB accumulator) the kernel is
// bound by the 2.4 GB it reads, 0.72 ms at 3.35 TB/s.  Each thread loads
// kUnroll records before it adds any, to keep enough loads in flight to
// cover HBM latency.  Shared atomics on few buckets serialise on bank
// conflicts; at B = 32 that contention, not the bytes, may bound it.  At
// B*D above the shared limit, scattered global atomics bound it.  wgmma
// and TMA do not apply to a scatter.
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream, do not synchronise and allocate nothing; the entry
// point zeroes the accumulator it is given (cudaMemsetAsync) and returns
// cudaGetLastError() so a refused launch surfaces at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kDtypeBF16 = 1;
constexpr int kSharedLimit = 200 * 1024;  // bytes of (B, D) float32 tile

__device__ __forceinline__ float load_val(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_val(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

// keep[i]: a valid row whose key names a bucket (the unsigned compare drops
// negative keys too)
__device__ __forceinline__ bool keep_row(int key, const uint8_t* valid,
                                         long long i, int num_buckets) {
  return (unsigned)key < (unsigned)num_buckets &&
         (valid == nullptr || valid[i] != 0);
}

template <typename T>
__device__ __forceinline__ void add_row(float* dst, int key,
                                        const T* values, long long i,
                                        int d) {
  float* cell = dst + (long long)key * d;
  const long long base = i * d;
  for (int j = 0; j < d; ++j) atomicAdd(cell + j, load_val(values, base + j));
}

// The record loop: grid-stride, kUnroll rows loaded per thread before any
// is added.  `dst` is the block's shared tile or the global accumulator.
template <typename T>
__device__ __forceinline__ void accumulate(const int* __restrict__ keys,
                                           const T* __restrict__ values,
                                           const uint8_t* __restrict__ valid,
                                           long long n, int num_buckets,
                                           int d, float* dst) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int key[kUnroll];
    bool keep[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = i + u * stride;
      key[u] = keys[r];
      keep[u] = keep_row(key[u], valid, r, num_buckets);
      val[u] = d == 1 ? load_val(values, r) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!keep[u]) continue;
      if (d == 1)
        atomicAdd(dst + key[u], val[u]);
      else
        add_row(dst, key[u], values, i + u * stride, d);
    }
  }
  for (; i < n; i += stride) {
    const int key = keys[i];
    if (keep_row(key, valid, i, num_buckets)) add_row(dst, key, values, i, d);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_shared(const int* __restrict__ keys, const T* __restrict__ values,
               const uint8_t* __restrict__ valid, long long n,
               int num_buckets, int d, float* __restrict__ acc) {
  extern __shared__ float tile[];
  const int cells = num_buckets * d;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) tile[c] = 0.f;
  __syncthreads();
  accumulate(keys, values, valid, n, num_buckets, d, tile);
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const float s = tile[c];
    if (s != 0.f) atomicAdd(acc + c, s);  // x + 0 == x: skip empty cells
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_global(const int* __restrict__ keys, const T* __restrict__ values,
               const uint8_t* __restrict__ valid, long long n,
               int num_buckets, int d, float* __restrict__ acc) {
  accumulate(keys, values, valid, n, num_buckets, d, acc);
}

__global__ void __launch_bounds__(kThreads)
round_to_bf16(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
              long long cells) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < cells; c += stride)
    out[c] = __float2bfloat16(acc[c]);  // round to nearest even
}

int blocks_for(long long work, int per_sm_cap) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long wave = (long long)sms * per_sm_cap;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <typename T>
int launch_combine(const int* keys, const T* values, const uint8_t* valid,
                   long long n, int num_buckets, int d, float* acc,
                   cudaStream_t s) {
  const long long tile_bytes = (long long)num_buckets * d * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (tile_bytes <= kSharedLimit && tile_bytes <= optin) {
    const int bytes = (int)tile_bytes;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          combine_shared<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, combine_shared<T>,
                                                  kThreads, bytes);
    if (per_sm < 1) per_sm = 1;
    combine_shared<T><<<blocks_for(n, per_sm), kThreads, bytes, s>>>(
        keys, values, valid, n, num_buckets, d, acc);
  } else {
    combine_global<T><<<blocks_for(n, 2048 / kThreads), kThreads, 0, s>>>(
        keys, values, valid, n, num_buckets, d, acc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys: (n,) int32; values: (n, d) float32 (dtype 0) or bfloat16 (dtype 1);
// valid: (n,) uint8 or null (all valid); acc: (num_buckets, d) float32,
// zeroed here; out: (num_buckets, d) bfloat16 for bfloat16 values (null
// for float32, whose output is acc itself).
extern "C" int hash_combine_launch(const void* keys, const void* values,
                                   const void* valid, long long n,
                                   int num_buckets, int d, int dtype,
                                   void* acc, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)num_buckets * d;
  cudaError_t e = cudaMemsetAsync(acc, 0, cells * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const int* k = static_cast<const int*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* a = static_cast<float*>(acc);
  if (n > 0 && cells > 0) {
    const int err =
        dtype == kDtypeBF16
            ? launch_combine(k, static_cast<const __nv_bfloat16*>(values), v,
                             n, num_buckets, d, a, s)
            : launch_combine(k, static_cast<const float*>(values), v, n,
                             num_buckets, d, a, s);
    if (err != 0) return err;
  }
  if (dtype == kDtypeBF16 && cells > 0) {
    round_to_bf16<<<blocks_for(cells, 2048 / kThreads), kThreads, 0, s>>>(
        a, static_cast<__nv_bfloat16*>(out), cells);
  }
  return (int)cudaGetLastError();
}
