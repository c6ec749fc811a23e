// fused_fold.cu — the streaming engine's per-micro-batch fold as one
// hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_fold/kernel.py::_fused_fold_kernel, the
// Pallas TPU kernel behind backend="pallas".  It computes the same
// function: decode float32 wire rows, bucketize raw keys with the murmur3
// finalizer when the key space is hashed, fan each record out to windows
// last - j (j < n_windows, j < fanout), count pairs below min_window as
// late, map each live window to ring slot w mod n_slots (a floor mod:
// sliding windows near the start of a stream are negative), and
// accumulate [value-or-1, 1] into channels [base, base+1] of the flat
// (n_slots * carry_buckets, C) carry, in place.  Stats are int32
// [late, folded, 0].
//
// Design.  The TPU kernel's one-hot x MXU matmul was a workaround for the
// TPU's missing scatter; Hopper has fast global atomics, so the fold is a
// plain scatter: one thread per record (grid-stride), looping over its
// fan-out.
//   * sum / count: atomicAdd of value-or-1 and 1 straight into the carry.
//     Float atomics change the order of the sums; integer-valued sums
//     below 2^24 are exact in any order, so the result is bit-identical to
//     the plain version on such data.
//   * min / max: two passes, so the result does not depend on the order of
//     the atomics.  Pass A folds each live pair's value into a per-cell
//     scratch extremum (atomicMin/Max on an order-preserving int encoding
//     of the float) and its count into a per-cell scratch count.  Pass B,
//     one thread per cell, combines scratch and carry exactly as the
//     reference does: eff = old_c > 0 ? old_v : +-inf, new_c = old_c + cnt,
//     new_v = new_c > 0 ? min/max(eff, ext) : 0.
//   * late and folded are reduced per block (warp shuffles, then shared
//     memory) and added with one atomicAdd per block into the stats the
//     wrapper zeroed.
//   * channel_base and C are honoured: only channels [base, base+1] of a
//     cell are written, so plans sharing a carry never touch each other.
//
// What bounds it on an H100.  At the streaming path's shape (a 65,536-row
// micro-batch into a 0.64 MB carry) the whole fold is a few microseconds
// of work, so launch latency bounds it.  At the large kernel-check shape
// (2^22 rows into a 64 MiB carry, bigger than the 50 MB L2) it is bound by
// the throughput of scattered atomics that miss L2, not by the bytes the
// rows take.  The design does nothing about either yet: a shared-memory
// carry tile or a sort-then-segment reduction would cut the misses, and
// CUDA graphs would amortise the launches.  wgmma and TMA do not apply to
// a scatter.
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream, do not synchronise and allocate nothing; the entry
// point returns cudaGetLastError() so a refused launch surfaces at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKindSum = 0;
constexpr int kKindCount = 1;
constexpr int kKindMin = 2;
constexpr int kKindMax = 3;

__device__ __forceinline__ int bucketize(float key, int num_buckets,
                                         int hashed) {
  int k = (int)key;  // truncates toward zero, as the reference's astype
  if (!hashed) return k;
  uint32_t h = (uint32_t)k;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (int)(h % (uint32_t)num_buckets);
}

// Order-preserving float <-> int encoding: for non-NaN floats,
// a < b  <=>  enc(a) < enc(b), so integer atomicMin/Max give the float
// extremum.
__device__ __forceinline__ int ordered_enc(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float ordered_dec(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7FFFFFFF);
}

__device__ __forceinline__ int block_sum(int v, int* shared) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? shared[threadIdx.x] : 0;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
fold_rows(const float* __restrict__ rows, long long n_rows,
          float* __restrict__ carry, long long size, int channels,
          int* __restrict__ stats, int* __restrict__ ext,
          float* __restrict__ cnt, int fanout, int n_slots, int num_buckets,
          int carry_buckets, int channel_base, int hashed, int host_wire,
          int kind, int min_window) {
  __shared__ int red[kThreads / 32];
  int late = 0, folded = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    int last, n_windows, bucket, fan;
    float val;
    bool valid;
    if (host_wire) {
      const float* r = rows + i * 4;
      last = (int)r[0];  // the host already assigned the slot
      n_windows = 1;
      bucket = bucketize(r[1], num_buckets, hashed);
      val = r[2];
      valid = r[3] > 0.f;
      fan = 1;
    } else {
      const float* r = rows + i * 5;
      last = (int)r[0];
      n_windows = (int)r[1];
      bucket = bucketize(r[2], num_buckets, hashed);
      val = r[3];
      valid = r[4] > 0.f;
      fan = fanout;
    }
    if (!valid) continue;
    for (int j = 0; j < fan && j < n_windows; ++j) {
      int slot;
      if (host_wire) {
        slot = last;
      } else {
        const int w = last - j;
        if (w < min_window) {
          ++late;
          continue;
        }
        slot = ((w % n_slots) + n_slots) % n_slots;  // floor mod
      }
      ++folded;
      const long long flat = (long long)slot * carry_buckets + bucket;
      if (flat < 0 || flat >= size) continue;  // the reference drops these
      if (kind == kKindSum || kind == kKindCount) {
        float* cell = carry + flat * channels + channel_base;
        atomicAdd(cell, kind == kKindCount ? 1.f : val);
        atomicAdd(cell + 1, 1.f);
      } else {
        if (kind == kKindMin)
          atomicMin(ext + flat, ordered_enc(val));
        else
          atomicMax(ext + flat, ordered_enc(val));
        atomicAdd(cnt + flat, 1.f);
      }
    }
  }
  late = block_sum(late, red);
  __syncthreads();
  folded = block_sum(folded, red);
  if (threadIdx.x == 0) {
    if (late) atomicAdd(stats + 0, late);
    if (folded) atomicAdd(stats + 1, folded);
  }
}

__global__ void __launch_bounds__(kThreads)
combine_extrema(float* __restrict__ carry, long long size, int channels,
                const int* __restrict__ ext, const float* __restrict__ cnt,
                int channel_base, int kind) {
  const float neutral = kind == kKindMin ? __int_as_float(0x7F800000)
                                         : __int_as_float(0xFF800000);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < size; c += stride) {
    float* cell = carry + c * channels + channel_base;
    const float old_v = cell[0], old_c = cell[1];
    const float e = ordered_dec(ext[c]);
    const float eff = old_c > 0.f ? old_v : neutral;
    const float comb = kind == kKindMin ? fminf(eff, e) : fmaxf(eff, e);
    const float new_c = old_c + cnt[c];
    cell[0] = new_c > 0.f ? comb : 0.f;
    cell[1] = new_c;
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  return (int)blocks;
}

}  // namespace

extern "C" int fused_fold_launch(
    const void* rows, long long n_rows, void* carry, long long size,
    int channels, void* stats, void* ext_scratch, void* cnt_scratch,
    int fanout, int n_slots, int num_buckets, int carry_buckets,
    int channel_base, int hashed, int host_wire, int kind, int min_window,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    fold_rows<<<grid_for(n_rows), kThreads, 0, s>>>(
        static_cast<const float*>(rows), n_rows, static_cast<float*>(carry),
        size, channels, static_cast<int*>(stats),
        static_cast<int*>(ext_scratch), static_cast<float*>(cnt_scratch),
        fanout, n_slots, num_buckets, carry_buckets, channel_base, hashed,
        host_wire, kind, min_window);
  }
  if ((kind == kKindMin || kind == kKindMax) && size > 0) {
    combine_extrema<<<grid_for(size), kThreads, 0, s>>>(
        static_cast<float*>(carry), size, channels,
        static_cast<const int*>(ext_scratch),
        static_cast<const float*>(cnt_scratch), channel_base, kind);
  }
  return static_cast<int>(cudaGetLastError());
}
