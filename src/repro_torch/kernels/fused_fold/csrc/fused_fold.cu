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
// (n_slots * carry_buckets, C) carry, in place.  Pairs whose flat id falls
// outside the carry are dropped (and still counted as folded).  Stats are
// int32 [late, folded, 0].
//
// Design.  The TPU kernel's one-hot x MXU matmul was a workaround for the
// TPU's missing scatter; Hopper has fast global atomics, so the fold is a
// scatter: one thread per record (grid-stride, 512-thread blocks), looping
// over its fan-out.  A fold is ONE cooperative launch (cudaLaunchCooperativeKernel, at most
// the co-resident blocks, which fused_fold_prepare computes once per
// geometry), with no state outside the launch: stats and the min/max
// scratch are the caller's uninitialised (torch.empty) buffers, and
// grid.sync() orders what a fill launch ordered before.
//   * sum / count: the [value-or-1, 1] pair is one vector reduction,
//     atomicAdd(float2*, float2) (red.global.v2.f32, compute capability
//     9.x, each element atomic), wherever the cell is 8-byte aligned: C
//     and channel_base even and the carry 8-byte aligned, which every plan
//     the port builds meets (C 2 or 4, base 0 or 2).  An odd C or base
//     takes the scalar pair.  The launch picks the instance.  Integer-valued
//     sums below 2^24 are exact in any order, so the result is
//     bit-identical to the plain version on such data.
//   * late and folded are reduced per block (warp shuffles, then shared
//     memory).  Block 0 zeroes the stats before the grid barrier; after
//     it, each block adds its partials with one atomicAdd a counter.
//   * min / max: three phases with grid barriers between them, so the
//     result does not depend on the order of the atomics.  Init: every
//     cell's scratch (int2 [extremum, count]) set to the neutral
//     extremum (an order-preserving int encoding of +-inf) and 0.  Pass
//     A: each live pair's value folded into its cell's extremum
//     (atomicMin/Max on the encoding) and its count.  Pass B, one thread
//     per cell, combines scratch and carry exactly as the reference does:
//     eff = old_c > 0 ? old_v : +-inf, new_c = old_c + cnt, new_v = new_c
//     > 0 ? min/max(eff, ext) : 0.
//   * channel_base and C are honoured: only channels [base, base+1] of a
//     cell are written, so plans sharing a carry never touch each other.
//   * rows are read directly (five 4-byte loads a device-wire row; a
//     warp's 32 rows are 640 contiguous bytes, which L1 serves): the rows
//     are not what bounds the fold, so they are not staged.
//
// What bounds it on an H100.  At the streaming path's shape (a 65,536-row
// micro-batch into a 0.64 MB carry) the whole fold is a few microseconds
// of work: the launch, one grid barrier (the largest fixed cost, and the
// price of writing stats without a fill launch) and ~330k vector
// reductions into L2, so latency bounds it, and the host's time per call
// (the wrapper's Python, the stats allocation, the launch call) more so.
// At the large kernel-check shape (2^22 rows into a 64 MiB carry, bigger
// than the 50 MB L2) it is bound by scattered reductions that miss L2;
// the paired reduction halves their number but not the sectors they
// touch, so it gains far less than 2x there.  A shared-memory tile would
// not help: the main shape's carry does not fit one SM, and a batch puts
// only ~5 pairs on a cell.  wgmma and TMA do not apply to a scatter.
//
// Interface: plain C, loaded with ctypes.  fused_fold_prepare fills a
// geometry's co-resident block count once; fused_fold_launch takes the
// packed geometry by pointer and only the per-call pointers, counts and
// stream, launches on the caller's stream, does not synchronise and
// allocates nothing, switches to the geometry's device only when the
// calling thread is on another (and back), and returns the launch's error
// so a refused launch surfaces at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The geometry a plan fixes, packed once by the wrapper (ops._Geometry
// mirrors this layout field by field).
struct FoldGeometry {
  long long size;  // carry cells: n_slots * carry_buckets
  int fanout;
  int n_slots;
  int num_buckets;
  int carry_buckets;
  int channel_base;
  int hashed;
  int host_wire;
  int kind;
  int device;      // CUDA device index the plan runs on
  int max_blocks;  // co-resident blocks, filled by fused_fold_prepare
};

namespace {

constexpr int kThreads = 512;
constexpr int kKindSum = 0;
constexpr int kKindCount = 1;
constexpr int kKindMin = 2;
constexpr int kKindMax = 3;

struct FoldArgs {
  const float* rows;
  long long n_rows;
  float* carry;
  long long size;
  int channels;
  int* stats;
  int2* scratch;  // min / max only: [extremum, count] per cell
  int fanout;
  int n_slots;
  int num_buckets;
  int carry_buckets;
  int channel_base;
  int hashed;
  int min_window;
};

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

// Sums (late, folded) over the block; the totals are valid in thread 0.
__device__ __forceinline__ int2 block_sum(int2 v, int2* shared) {
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xFFFFFFFFu, v.x, off);
    v.y += __shfl_down_sync(0xFFFFFFFFu, v.y, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? shared[threadIdx.x] : make_int2(0, 0);
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_down_sync(0xFFFFFFFFu, v.x, off);
      v.y += __shfl_down_sync(0xFFFFFFFFu, v.y, off);
    }
  return v;
}

// One live pair into its cell.
template <int KIND, bool PAIR>
__device__ __forceinline__ void fold_pair(const FoldArgs& a, long long flat,
                                          float val) {
  if constexpr (KIND == kKindSum || KIND == kKindCount) {
    float* cell = a.carry + flat * a.channels + a.channel_base;
    const float v = KIND == kKindCount ? 1.f : val;
    if constexpr (PAIR) {
      atomicAdd(reinterpret_cast<float2*>(cell), make_float2(v, 1.f));
    } else {
      atomicAdd(cell, v);
      atomicAdd(cell + 1, 1.f);
    }
  } else {
    int2* s = a.scratch + flat;
    if constexpr (KIND == kKindMin)
      atomicMin(&s->x, ordered_enc(val));
    else
      atomicMax(&s->x, ordered_enc(val));
    atomicAdd(&s->y, 1);
  }
}

template <int KIND, bool HOST_WIRE, bool PAIR>
__global__ void __launch_bounds__(kThreads) fold_kernel(FoldArgs a) {
  constexpr bool kExtremum = KIND == kKindMin || KIND == kKindMax;
  __shared__ int2 red[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  if (tid == 0) {
    a.stats[0] = 0;
    a.stats[1] = 0;
    a.stats[2] = 0;
  }
  if constexpr (kExtremum) {
    const int2 init = make_int2(
        ordered_enc(__int_as_float(KIND == kKindMin ? 0x7F800000
                                                    : 0xFF800000)),
        0);
    for (long long c = tid; c < a.size; c += stride) a.scratch[c] = init;
    grid.sync();  // every cell's scratch is neutral before pass A
  }

  // Pass A: the rows.
  int2 acc = make_int2(0, 0);  // (late, folded)
  for (long long i = tid; i < a.n_rows; i += stride) {
    if constexpr (HOST_WIRE) {
      const float* r = a.rows + i * 4;
      if (!(r[3] > 0.f)) continue;
      const int slot = (int)r[0];  // the host already assigned the slot
      const int bucket = bucketize(r[1], a.num_buckets, a.hashed);
      ++acc.y;
      const long long flat = (long long)slot * a.carry_buckets + bucket;
      if (flat < 0 || flat >= a.size) continue;  // the reference drops it
      fold_pair<KIND, PAIR>(a, flat, r[2]);
    } else {
      const float* r = a.rows + i * 5;
      if (!(r[4] > 0.f)) continue;
      const int last = (int)r[0];
      const int n_windows = (int)r[1];
      const int bucket = bucketize(r[2], a.num_buckets, a.hashed);
      const float val = r[3];
      for (int j = 0; j < a.fanout && j < n_windows; ++j) {
        const int w = last - j;
        if (w < a.min_window) {
          ++acc.x;
          continue;
        }
        ++acc.y;
        const int slot = ((w % a.n_slots) + a.n_slots) % a.n_slots;
        const long long flat = (long long)slot * a.carry_buckets + bucket;
        if (flat < 0 || flat >= a.size) continue;
        fold_pair<KIND, PAIR>(a, flat, val);
      }
    }
  }
  acc = block_sum(acc, red);
  // Block 0 zeroed the stats before this barrier; for min / max every
  // pass-A update is also visible after it.
  grid.sync();
  if (threadIdx.x == 0) {
    if (acc.x) atomicAdd(a.stats + 0, acc.x);
    if (acc.y) atomicAdd(a.stats + 1, acc.y);
  }

  if constexpr (kExtremum) {
    // Pass B: scratch and carry combined cell by cell.
    const float neutral = __int_as_float(KIND == kKindMin ? 0x7F800000
                                                          : 0xFF800000);
    for (long long c = tid; c < a.size; c += stride) {
      float* cell = a.carry + c * a.channels + a.channel_base;
      const float old_v = cell[0], old_c = cell[1];
      const int2 s = a.scratch[c];
      const float e = ordered_dec(s.x);
      const float eff = old_c > 0.f ? old_v : neutral;
      const float comb = KIND == kKindMin ? fminf(eff, e) : fmaxf(eff, e);
      const float new_c = old_c + (float)s.y;
      cell[0] = new_c > 0.f ? comb : 0.f;
      cell[1] = new_c;
    }
  }
}

using KernelFn = void (*)(FoldArgs);

template <int KIND>
KernelFn instance(int host_wire, bool pair) {
  if constexpr (KIND == kKindMin || KIND == kKindMax) {
    return host_wire ? fold_kernel<KIND, true, false>
                     : fold_kernel<KIND, false, false>;
  } else {
    if (host_wire)
      return pair ? fold_kernel<KIND, true, true>
                  : fold_kernel<KIND, true, false>;
    return pair ? fold_kernel<KIND, false, true>
                : fold_kernel<KIND, false, false>;
  }
}

KernelFn select(int kind, int host_wire, bool pair) {
  switch (kind) {
    case kKindSum: return instance<kKindSum>(host_wire, pair);
    case kKindCount: return instance<kKindCount>(host_wire, pair);
    case kKindMin: return instance<kKindMin>(host_wire, pair);
    case kKindMax: return instance<kKindMax>(host_wire, pair);
    default: return nullptr;
  }
}

// Makes `device` current for the calling thread only if it is not, and
// restores the previous device on the way out.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace

// Fills g->max_blocks: the blocks of kThreads threads that can be resident
// at once on g->device for every instance this geometry may launch (the
// paired and the scalar sum for sum / count), which bounds a cooperative
// grid.  Fails with cudaErrorNotSupported on a device without cooperative
// launches.
extern "C" int fused_fold_prepare(FoldGeometry* g) {
  DeviceScope scope(g->device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int coop = 0, sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, g->device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 g->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int fewest = 1 << 30;
  for (int pair = 0; pair < 2; ++pair) {
    KernelFn fn = select(g->kind, g->host_wire, pair != 0);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(fn), kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < fewest) fewest = per_sm;
  }
  g->max_blocks = fewest * sms;
  return g->max_blocks > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// One fold, one cooperative launch.  `scratch` is min / max's (size, 2)
// int32 buffer (null for sum / count); `stats` three int32.  Neither needs
// any initial value.
extern "C" int fused_fold_launch(const FoldGeometry* g, const void* rows,
                                 long long n_rows, void* carry, int channels,
                                 void* stats, void* scratch, int min_window,
                                 void* stream) {
  const bool extremum = g->kind == kKindMin || g->kind == kKindMax;
  const bool pair = !extremum && channels % 2 == 0 &&
                    g->channel_base % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(carry) % 8 == 0;
  KernelFn fn = select(g->kind, g->host_wire, pair);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long work = extremum && g->size > n_rows ? g->size : n_rows;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // the stats are written even for no rows
  if (blocks > g->max_blocks) blocks = g->max_blocks;  // grid-stride beyond
  FoldArgs a{static_cast<const float*>(rows), n_rows,
             static_cast<float*>(carry), g->size, channels,
             static_cast<int*>(stats), static_cast<int2*>(scratch),
             g->fanout, g->n_slots, g->num_buckets, g->carry_buckets,
             g->channel_base, g->hashed, min_window};
  void* args[] = {&a};
  DeviceScope scope(g->device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fn), dim3((unsigned)blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}
