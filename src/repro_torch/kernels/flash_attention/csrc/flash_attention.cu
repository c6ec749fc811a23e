// flash_attention.cu — attention forward (prefill) and split-K decode as
// hand-written CUDA kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// repro/kernels/flash_attention/kernel.py:
//   * _fwd_kernel (flash_attention): online-softmax attention forward,
//     q (B, Hq, Sq, D) x k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D), with GQA
//     (q head h reads kv head h / (Hq / Hkv)), a causal mask (query i sees
//     keys j <= i), a sliding window (i - j < window), a logit softcap
//     (s <- c * tanh(s / c)) and a default scale of D^-0.5.  A row with no
//     live key writes 0.
//   * _decode_kernel (flash_decode): one query token per (batch, q head)
//     against a KV cache (B, Hkv, S, D) with per-row lengths: row b sees
//     keys [max(0, len_b - window), min(len_b, S)).
// Both compute the softmax in float32 and take float32 or bfloat16 inputs;
// the output has the inputs' dtype.
//
// Design.  The TPU kernel carries (m, l, acc) across a sequential grid axis
// over KV blocks.  Blocks on Hopper run in parallel and in no order, so
// that axis becomes a loop inside one block:
//   * fwd_wgmma (bfloat16, D in {64, 128, 256}): one block of three
//     warpgroups per (128-row q tile, q head, batch), q tiles launched
//     latest-first with the heads fastest, so the longest causal rows of
//     every head start first and the shortest fill the tail.  The block
//     walks the K/V tiles its rows can see (the causal triangle and the
//     window bound the range; fully masked tiles are never loaded):
//     kKeys = 128 keys a tile at D <= 128, 80 at D = 256 (FwdTile, which
//     flash_attention_fwd_tile reports to the wrapper).
//     - Producer: warpgroup 0 hands most of its registers to the consumers
//       (setmaxnreg 24 / 240) and one of its threads issues TMA loads
//       (cp.async.bulk.tensor, 128-byte swizzle): Q's tile once, then K and
//       V tiles into a two-slot ring per operand, each slot with a full
//       and an empty mbarrier; K of tile j + 1 goes out before V of tile j.
//     - Products: consumer warpgroups 1 and 2 own 64 rows each.  S = Q K^T
//       is wgmma with both operands in shared memory; O += P V is wgmma
//       with P in registers and V read in its (key, d) layout through the
//       transpose bit.  Tiles sit 1024-byte aligned in 128-byte column
//       blocks, so the descriptors' swizzle is the TMA's.
//     - Hiding the softmax: the consumers take turns at the tensor cores
//       through two named barriers (ping-pong), so one's softmax runs
//       under the other's products; within a warpgroup, Q K^T of tile j
//       and P V of tile j - 1 are issued together and the softmax of j
//       waits only for the first (wgmma.wait_group 1).  Both hold at
//       D = 256: the accumulator (128 registers), one score tile (32) and
//       P (16) fit in a consumer's 240.
//     - A cheaper softmax with the same numerics: logits in log2 units
//       (exp as ex2, log2(e) folded into the scale and the row max); the
//       scale and softcap folded into one multiply, c tanh(x) as
//       c - 2c / (1 + 2^(2 log2(e) x)) with ex2 and rcp.approx (an
//       absolute error of a few float32 ulps of c; tanh.approx's relative
//       2^-11 would exceed the rest of the softmax's error); the causal,
//       window and ragged-edge compares only on tiles that cross a
//       boundary.  m, l and O are float32; P is rounded once to bfloat16
//       for P V (up to 2^-9 max|v| absolute per element, where the TPU
//       kernel multiplies in float32) and l sums that rounded P, so the
//       weights applied to V sum to 1; the output is rounded once.
//     Rows past Sq and keys past Skv read as zeros from the TMA; the masks
//     drop such keys and the stores skip such rows, so any Sq and Skv work.
//   * fwd_rows (float32, and bfloat16 at other head dims): one warp per
//     query row walks its live key range with float32 FMAs; each lane
//     holds D/32 dimensions of q and of the accumulator.
//   * decode_cluster: split-K decode as one launch.  At B = 1 and Hkv = 8
//     the TPU grid has 8 (batch, kv head) programs for 132 SMs, so the
//     live range [max(0, len - window), min(len, S)) of each (row, kv
//     head) is cut among the C blocks of a thread-block cluster: grid (C,
//     Hkv, B), cluster (C, 1, 1), C from the rule in decode_geometry.h
//     (the largest size up to 8 that keeps all blocks resident, one an
//     SM; no split under 64 keys of S; sizes up to 16 launch on request,
//     but a 16-block cluster ran slower at Gemma's shapes).  The ranges
//     come from lengths on the device: no host sync per step.
//     - Loads: one producer thread copies the rank's K and V rows into a
//       ring of shared-memory slots with cp.async.bulk, one copy per
//       operand and tile (a (row, kv head)'s rows are contiguous), each
//       slot with a full and an empty mbarrier.  A range that does not
//       start on a 16-byte boundary is copied as the 16-byte envelope
//       around it and read at its offset, so any base and head dim take
//       the same path.
//     - Products: two groups of four consumer warps take turns at the
//       tiles, so two tiles are in work while the others load.  A warp
//       holds q of the whole GQA group (in registers, or in shared memory
//       at a group of 8 with 8 dimensions a lane), lanes over dimensions,
//       and takes 8 keys a step (4 at groups of 4 and 8, 2 at 8 with 8
//       dimensions a lane): the 32 or fewer scores in float32 go through
//       one warp reduction (a
//       butterfly that leaves each score in a few lanes), the lane that
//       holds a score takes its softcap and exponent, and the results
//       reach every lane through shared memory; the softmax is online in
//       log2 units with the forward's softcap formula; m, l and acc are
//       float32.
//     - Merge: the warps' states merge in the block's shared memory; after
//       a cluster barrier rank 0 reads every rank's (m, l, acc) through
//       distributed shared memory, merges them in rank order, normalises
//       and writes the output (an empty rank brings m = -inf, l = 0; a row
//       with no live key writes 0); a second barrier keeps the blocks
//       resident until it has read them.  Nothing but the output leaves
//       the launch, and it keeps nothing between calls.
//
// What bounds it on an H100.  Prefill is compute-bound: at one 8192-token
// Gemma 2 prompt a global layer does 4 * 16 * 256 * 8192^2 / 2 flops of
// Q K^T and P V (5.5e11, 0.56 ms at 989 TFLOP/s) against 34 MB of q, k, v
// and o.  fwd_wgmma reaches for the wgmma rate; what stands beside the
// products is the softmax on the special-function units: three ex2/rcp a
// score with the softcap, 3 x 64 x 80 / 16 = 960 clocks an 80-key tile per
// warpgroup, against 1,280 clocks of that warpgroup's products at D = 256
// (4 x 64 x 80 x 256 flops at 4,096 a clock per SM).  The ping-pong puts
// one warpgroup's softmax under the other's products; the two softmaxes
// still share the SM's special-function units, which is what keeps the
// kernel near twice its bound (PERF.md section 6).  The K/V tiles come
// mostly from L2 (each is read by the 64 q tiles of its head).
// Decode is byte-bound: it reads each live cache row of K and V once (67
// MB per global layer at B = 1, len = 8192, D = 256: 0.020 ms at 3.35
// TB/s).  At C = 8 that is 64 blocks, each of which must keep about 52 KB
// in flight at ~1 us of latency (Little's law); the ring's 6 slots of 32
// KB hold up to 192 KB.  The FMAs (2 G D a key, in float32 on the CUDA
// cores) need a tenth of the cores' rate at Gemma's group of 2 and about
// 40% at a group of 8 and D = 128, so the scores stay off the tensor
// cores; what holds the kernel above its bound is the latency of each
// warp's step (the loads, the reduction, the exponents) with 8 consumer
// warps an SM, and a fixed cost of launch, first tile and merge (the
// one-key case of chip_smoke.py's phase 9 measures it).
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream, do not synchronise and allocate nothing; each entry
// point returns cudaGetLastError() so a refused launch surfaces at once.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_geometry.h"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDtypeBF16 = 1;
constexpr int kThreads = 128;  // 4 warps in fwd_rows
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // keys loaded per warp step (fwd_rows)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float apply_cap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Lane `lane`'s EPL elements of a D-long row (dimension lane * EPL + e),
// as float32; dimensions at or past D read 0.  Rows whose length is exactly
// 32 * EPL load as 16-, 8- or 4-byte vectors.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* row, int lane, int D,
                                         float (&out)[EPL]) {
  const int base = lane * EPL;
  if constexpr (sizeof(T) * EPL == 16 || sizeof(T) * EPL == 8 ||
                sizeof(T) * EPL == 4) {
    if (D == 32 * EPL) {
      typedef typename std::conditional<
          sizeof(T) * EPL == 16, uint4,
          typename std::conditional<sizeof(T) * EPL == 8, uint2,
                                    uint32_t>::type>::type V;
      const V raw = *reinterpret_cast<const V*>(row + base);
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < EPL; ++e) out[e] = to_f(el[e]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    out[e] = base + e < D ? to_f(row[base + e]) : 0.f;
}

// One warp's online softmax over keys lo .. hi - 1 for one query vector
// q.  (m, l, acc) carry the running max, the running sum of exp(s - m) and
// the unnormalised output; every lane holds the same m and l, and its own
// dimensions of acc.
template <typename T, int EPL>
__device__ __forceinline__ void attend(const float (&q)[EPL],
                                       const T* __restrict__ kb,
                                       const T* __restrict__ vb, int D,
                                       int lo, int hi, float scale,
                                       float softcap, float& m, float& l,
                                       float (&acc)[EPL]) {
  const int lane = threadIdx.x & 31;
  for (int j = lo; j < hi; j += kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = j + u;
      ok[u] = key < hi;
      if (ok[u]) {
        load_row<T, EPL>(kb + (long long)key * D, lane, D, kr[u]);
        load_row<T, EPL>(vb + (long long)key * D, lane, D, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float s[kUnroll];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(q[e], kr[u][e], dot);
      dot = apply_cap(warp_sum(dot) * scale, softcap);
      s[u] = ok[u] ? dot : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = __expf(s[u] - m_new);  // exp(-inf) = 0: masked keys
      psum += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vr[u][e], acc[e]);
    }
    l = l * alpha + psum;
    m = m_new;
  }
}

// ---------------------------------------------------------------------------
// Forward, float32 FMA path: one warp per query row.
// ---------------------------------------------------------------------------

template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
fwd_rows(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
         int Skv, int D, int causal, int window, float softcap, float scale) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= Sq) return;  // no block-wide barrier below
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long long qrow = ((long long)(b * Hq + h) * Sq + row) * D;
  const long long kvbase = (long long)(b * Hkv + hk) * Skv * D;
  float qv[EPL];
  load_row<T, EPL>(q + qrow, lane, D, qv);
  const int lo = window > 0 ? max(0, row - window + 1) : 0;
  const int hi = causal ? min(Skv, row + 1) : Skv;
  float m = kNegInf, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  attend<T, EPL>(qv, k + kvbase, v + kvbase, D, lo, hi, scale, softcap, m, l,
                 acc);
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int dim = lane * EPL + e;
    if (dim < D) store(o + qrow + dim, acc[e] * inv);
  }
}

// ---------------------------------------------------------------------------
// Forward, bfloat16 tensor-core path: fwd_wgmma.
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTurn = 1;          // named barrier kTurn + w: consumer w's turn
constexpr float kLog2e = 1.4426950408889634f;

// Tile shapes.  A block owns 128 query rows (64 per consumer warpgroup);
// K and V come in tiles of kKeys keys through a ring of kStages slots per
// operand.  A tile row of D bf16 is stored as D / 64 column blocks of 128
// bytes (the TMA box width under the 128-byte swizzle); at D = 256 the
// smem is 64 KB of Q + 2 x 2 x 40 KB of K/V, 225 KB of the 227 a block
// may use.  80 keys rather than 64 there: Q K^T's operands, both read
// from shared memory, then cost 112 bytes a clock of the SM's 128 where
// 64 keys cost all 128 (2 KB of Q and 2 KB of K every 32 clocks).
// fwd_wgmma serves the bfloat16 forward at these head dims; fwd_rows the
// rest.
constexpr bool wgmma_serves(int D, int dtype) {
  return dtype == kDtypeBF16 && (D == 64 || D == 128 || D == 256);
}

template <int D>
struct FwdTile {
  static constexpr int kRows = 128;
  static constexpr int kKeys = D == 256 ? 80 : 128;
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kKeys * D * 2;
  static constexpr int kBarriers = 1 + 4 * kStages;  // Q; K, V full/empty
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

template <int D>
int report_tile(int* rows, int* keys, int* stages) {
  *rows = FwdTile<D>::kRows;
  *keys = FwdTile<D>::kKeys;
  *stages = FwdTile<D>::kStages;
  return 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 3-d tensor map (coordinates innermost first) into shared
// memory at `dst`; the copy's bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Named barriers over the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// not move their other uses across this point.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, relative error 2^-22
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {  // 1/x, 1 ulp
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 80) (+)= A(64 x 16) B(16 x 80): A and B from shared memory,
// both K-major (Q and K rows), 128-byte swizzle; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39 "
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128) (+)= A(64 x 16) B(16 x 128): A and B from shared memory,
// both K-major (Q and K rows), 128-byte swizzle; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16) B(16 x 64): A (P) from registers, B (V)
// from shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16) B(16 x 128): A (P) from registers, B (V)
// from shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D(64 x 256) += A(64 x 16) B(16 x 256): A (P) from registers, B (V)
// from shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// The producer's load of K or V tile i (keys key0 .. key0 + kKeys of kv
// slice `kv`) into its ring slot: once the consumers have released the
// slot's previous tile (the empty barrier's phase before this use), the
// slot's full barrier expects the tile's bytes and the TMA delivers them.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t ring, const CUtensorMap* map,
                                        uint32_t full, uint32_t empty, int i,
                                        int key0, int kv) {
  typedef FwdTile<D> T;
  const int slot = i % T::kStages;
  mbar_wait(empty + 8 * slot, ((i / T::kStages) & 1) ^ 1);
  mbar_expect_tx(full + 8 * slot, T::kKVBytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(ring + slot * T::kKVBytes + c * T::kKeys * 128, map,
             full + 8 * slot, c * 64, key0, kv);
}

// Fragment layouts (PTX ISA, wgmma m64nNk16 with .bf16 inputs): in a
// warpgroup's float32 accumulator, warp w's thread with g = lane / 4 and
// t = lane % 4 holds in register 4c + e row 16w + g (e < 2) or 16w + g + 8
// (e >= 2), column 8c + 2t + (e & 1).  A taken from registers has the same
// (row, column pair) layout over 16 columns, so after rounding, a score
// tile's two 8-key chunks 2kk and 2kk + 1 are P's A fragment for keys
// [16kk, 16kk + 16).

// S = Q K^T for one tile: Q's 64 rows of this warpgroup at `qa` (K-major:
// 128-byte column blocks of 128 rows), the K tile at `kb` (column blocks
// of kKeys rows); 16 columns of D a step, 32 bytes into a 128-byte row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[FwdTile<D>::kKeys / 2],
                                         uint32_t qa, uint32_t kb) {
  constexpr int kKeys = FwdTile<D>::kKeys;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(s,
             smem_desc(qa + (kk / 4) * (FwdTile<D>::kRows * 128) + col, 16,
                       1024),
             smem_desc(kb + (kk / 4) * (kKeys * 128) + col, 16, 1024),
             kk > 0);
  }
}

// O += P V for one tile: P from registers, V at `vb` in its (key, d)
// layout, read MN-major: 16 keys (two 1024-byte swizzle atoms) a step,
// the D / 64 column blocks kKeys * 128 bytes apart.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / 2], const uint32_t (&p)[FwdTile<D>::kKeys / 4],
    uint32_t vb) {
  constexpr int kKeys = FwdTile<D>::kKeys;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             smem_desc(vb + kk * 2048, kKeys * 128, 1024));
}

// Whether a tile of keys [k0, k0 + kKeys) holds a dead key for some row of
// [r0, r0 + 64): it crosses the diagonal, the window's edge or Skv.
__device__ __forceinline__ bool tile_needs_mask(int k0, int kKeys, int r0,
                                                int Skv, int causal,
                                                int window) {
  return (causal && k0 + kKeys - 1 > r0) ||
         (window > 0 && k0 <= r0 + 63 - window) || k0 + kKeys > Skv;
}

// O *= alpha row by row, skipped where every alpha of the warp is exactly
// 1 (no row maximum moved: the common case once rows have seen their
// largest scores), which changes no bit.
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }
}

// One tile's online softmax on this thread's two rows (ra, rb), in log2
// units.  Scores become t = s * k1, or with the softcap c
// t = c1 - c2 / (1 + 2^(s * k1)) = log2(e) c tanh(s scale / c) (k1 =
// 2 log2(e) scale / c, c1 = log2(e) c, c2 = 2 c1): its absolute error is a
// few float32 ulps of c1 (ex2 2^-22 relative, rcp 1 ulp), far below P's
// bf16 rounding.  Where `mask` (tiles across the diagonal, the window's
// edge or Skv) dead keys become -inf; elsewhere no compare runs.  Then
// m <- max(m, row max), alpha = 2^(m_old - m), s <- p = 2^(t - m) rounded
// once to bf16 (the P that P V multiplies) and l <- l alpha + sum p (a
// per-thread partial; the quad adds at the end).  l sums the rounded P,
// so the weights applied to V sum to exactly 1, as the exact softmax's
// do: P's rounding error (2^-9 relative) enters the output as
// sum p d (v - o) / l rather than sum p d v / l.
// A row with no live key yet keeps m = -inf and p = 0 (its max is taken as
// 0 for the exponent).
template <int N>
__device__ __forceinline__ void online_softmax(
    float (&s)[N], float (&m)[2], float (&l)[2], float (&alpha)[2], bool cap,
    float k1, float c1, float c2, bool mask, int k0, int ra, int rb, int col,
    int Skv, int causal, int window) {
  if (cap) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      s[i] = fmaf(-c2, rcp(1.f + ex2(s[i] * k1)), c1);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= k1;
  }
  if (mask) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int key = k0 + (i / 4) * 8 + col + (i & 1);
      const int row = (i & 2) ? rb : ra;
      const bool live = key < Skv && (!causal || row >= key) &&
                        (window <= 0 || row - key < window);
      if (!live) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - mu[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < N; i += 2) {  // a pair shares its row
    const uint32_t pb = pack_bf16(ex2(s[i] - mu[(i >> 1) & 1]),
                                  ex2(s[i + 1] - mu[(i >> 1) & 1]));
    s[i] = __uint_as_float(pb << 16);
    s[i + 1] = __uint_as_float(pb & 0xffff0000u);
    sum[(i >> 1) & 1] += s[i] + s[i + 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// q: (B, Hq, Sq, D), k, v: (B, Hkv, Skv, D) through 3-d tensor maps
// (D, rows, batch x heads) with the 128-byte swizzle; o written directly.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
          int Hq, int Hkv, int Sq, int Skv, int causal, int window,
          float softcap, float scale) {
  typedef FwdTile<D> T;
  constexpr int kKeys = T::kKeys, kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // every tile 1024-byte aligned: the swizzle pattern spans 8 rows of 128 B
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + T::kQBytes;  // kStages K tiles, then V tiles
  const uint32_t v_s = k_s + kStages * T::kKVBytes;
  const uint32_t bar_q = v_s + kStages * T::kKVBytes;
  const uint32_t full_k = bar_q + 8, empty_k = full_k + 8 * kStages;
  const uint32_t full_v = empty_k + 8 * kStages;
  const uint32_t empty_v = full_v + 8 * kStages;

  // Launch order: q tiles latest first with the heads fastest, so every
  // head's longest causal rows start before any shorter tile (with the q
  // tiles fastest, the last heads' longest tiles would start last and run
  // on alone).
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int h = lin % Hq, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - lin / Hq) * T::kRows;
  // the live key tiles of the block's rows (the causal triangle and the
  // window bound them; fully masked tiles are never loaded)
  int lo = 0, hi = Skv;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(Skv, q0 + T::kRows);
  const int t_lo = lo / kKeys;
  const int n = max(0, (hi + kKeys - 1) / kKeys - t_lo);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2);  // one thread per consumer warpgroup
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load; K of tile j + 1 goes out
    // before V of tile j, which the consumers need one product later.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load(q_s + c * T::kRows * 128, &tq, bar_q, c * 64, q0,
                 b * Hq + h);
      const int kv = b * Hkv + h / (Hq / Hkv);
      load_kv<D>(k_s, &tk, full_k, empty_k, 0, t_lo * kKeys, kv);
      for (int j = 0; j < n; ++j) {
        if (j + 1 < n)
          load_kv<D>(k_s, &tk, full_k, empty_k, j + 1,
                     (t_lo + j + 1) * kKeys, kv);
        load_kv<D>(v_s, &tv, full_v, empty_v, j, (t_lo + j) * kKeys, kv);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1;  // consumer warpgroup 0 or 1
    const int tid = threadIdx.x % 128;
    const int r0 = q0 + 64 * w;  // this warpgroup's first row
    const int ra = r0 + 16 * (tid / 32) + (tid % 32) / 4, rb = ra + 8;
    const int col = 2 * (tid % 4);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (n > 0) {
      float s[kKeys / 2], alpha[2];
      uint32_t p[kKeys / 4];
      const bool cap = softcap > 0.f;
      const float k1 = cap ? 2.f * kLog2e * scale / softcap : kLog2e * scale;
      const float c1 = kLog2e * softcap, c2 = 2.f * c1;
      const uint32_t qa = q_s + w * 64 * 128;
      // Ping-pong: consumer w issues its products on its turn (named
      // barrier kTurn + w), then hands the turn to the other, so one
      // warpgroup's softmax runs under the other's products.  Every
      // consumer takes n + 1 turns; consumer 1's first arrive lets
      // consumer 0 start, and it skips the arrive after its last turn.
      if (w == 1) named_arrive(kTurn);
      mbar_wait(bar_q, 0);

      // tile 0: Q K^T alone
      mbar_wait(full_k, 0);
      named_sync(kTurn + w);
      reg_fence(s);
      wgmma_fence();
      issue_qk<D>(s, qa, k_s);
      wgmma_commit();
      named_arrive(kTurn + 1 - w);
      wgmma_wait<0>();
      reg_fence(s);
      if (tid == 0) mbar_arrive(empty_k);
      online_softmax(s, m, l, alpha, cap, k1, c1, c2,
                     tile_needs_mask(t_lo * kKeys, kKeys, r0, Skv, causal,
                                     window),
                     t_lo * kKeys, ra, rb, col, Skv, causal, window);
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i)
        p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

      // tile j: Q K^T of j; while it runs, O's rescale for the softmax of
      // j - 1; then P V of j - 1.  The softmax of j waits only for Q K^T.
      for (int j = 1; j < n; ++j) {
        const int sk = j % kStages, sv = (j - 1) % kStages;
        mbar_wait(full_k + 8 * sk, (j / kStages) & 1);
        named_sync(kTurn + w);
        reg_fence(s);
        wgmma_fence();
        issue_qk<D>(s, qa, k_s + sk * T::kKVBytes);
        wgmma_commit();
        rescale(acc, alpha);
        mbar_wait(full_v + 8 * sv, ((j - 1) / kStages) & 1);
        reg_fence(acc);
        reg_fence(p);
        wgmma_fence();
        issue_pv<D>(acc, p, v_s + sv * T::kKVBytes);
        wgmma_commit();
        named_arrive(kTurn + 1 - w);
        wgmma_wait<1>();
        reg_fence(s);
        if (tid == 0) mbar_arrive(empty_k + 8 * sk);
        const int k0 = (t_lo + j) * kKeys;
        online_softmax(s, m, l, alpha, cap, k1, c1, c2,
                       tile_needs_mask(k0, kKeys, r0, Skv, causal, window),
                       k0, ra, rb, col, Skv, causal, window);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(p);
        if (tid == 0) mbar_arrive(empty_v + 8 * sv);
#pragma unroll
        for (int i = 0; i < kKeys / 4; ++i)
          p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      }

      // P V of the last tile
      const int sv = (n - 1) % kStages;
      mbar_wait(full_v + 8 * sv, ((n - 1) / kStages) & 1);
      named_sync(kTurn + w);
      rescale(acc, alpha);
      reg_fence(acc);
      reg_fence(p);
      wgmma_fence();
      issue_pv<D>(acc, p, v_s + sv * T::kKVBytes);
      wgmma_commit();
      if (w == 0) named_arrive(kTurn + 1);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(p);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    bf16* ob = o + (long long)(b * Hq + h) * Sq * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (ra < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)ra * D + 8 * c + col) =
            pack_bf16(acc[4 * c] * inv[0], acc[4 * c + 1] * inv[0]);
      if (rb < Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)rb * D + 8 * c + col) =
            pack_bf16(acc[4 * c + 2] * inv[1], acc[4 * c + 3] * inv[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Split-K decode: one cluster launch.
// ---------------------------------------------------------------------------

namespace dg = decode_geometry;

// cp.async.bulk: `bytes` (a multiple of 16) from global `src` (16-byte
// aligned) into shared memory at `dst`; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The dimension a lane holds in its e-th register: a contiguous run of EPL
// (vector loads from rows that start on 16-byte boundaries), or every 32nd
// (scalar loads, conflict-free in shared memory from any element offset).
template <bool VEC, int EPL>
__device__ __forceinline__ int dim_of(int lane, int e) {
  return VEC ? lane * EPL + e : lane + 32 * e;
}

// Two bfloat16 (the low and the high half of a 32-bit word) or one
// float32 word as float32: bit operations only, so the loaded vectors stay
// in registers.
__device__ __forceinline__ void unpack(uint32_t w, float* out, bf16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}

// Lane `lane`'s EPL elements of a D-long row in shared memory, as float32;
// dimensions at or past D read 0.
template <typename T, int EPL, bool VEC>
__device__ __forceinline__ void smem_row(const T* row, int lane, int D,
                                         float (&out)[EPL]) {
  constexpr int kBytes = (int)sizeof(T) * EPL;
  constexpr int kPer = 4 / (int)sizeof(T);  // elements a 32-bit word
  if constexpr (VEC && kBytes % 4 == 0) {
    if ((lane + 1) * EPL <= D) {
      const T* p = row + lane * EPL;
      if constexpr (kBytes >= 16) {
#pragma unroll
        for (int c = 0; c < kBytes / 16; ++c) {
          const uint4 v = reinterpret_cast<const uint4*>(p)[c];
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            unpack(w[i], out + (4 * c + i) * kPer, T());
        }
      } else if constexpr (kBytes == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        unpack(v.x, out, T());
        unpack(v.y, out + kPer, T());
      } else {
        unpack(*reinterpret_cast<const uint32_t*>(p), out, T());
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int dim = dim_of<VEC, EPL>(lane, e);
    out[e] = dim < D ? to_f(row[dim]) : 0.f;
  }
}

// One butterfly level of warp_scatter: of the 2 H values left, a lane
// keeps the half its lane bit (offset 32 H / N) picks and adds its
// partner's copy of that half.  Template recursion keeps every index a
// constant, so the values stay in registers.
template <int H, int N>
__device__ __forceinline__ void scatter_level(float (&s)[N], int lane,
                                              int& idx) {
  if constexpr (H >= 1) {
    constexpr int o = 32 * H / N;
    const bool up = (lane & o) != 0;
    idx += up ? H : 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = up ? s[j] : s[j + H];
      const float keep = up ? s[j + H] : s[j];
      s[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    scatter_level<H / 2, N>(s, lane, idx);
  }
}

// The warp totals of N partial sums (N a power of two, 4 <= N <= 32): a
// butterfly that halves the values each level (lane bits 4, 3, ... pick
// which half a lane keeps), then the lanes that share a value finish it.
// Returns the total of value `idx` (the same for the 32 / N lanes that
// hold it); N - 1 + 5 - log2(N) shuffles instead of 5 N.
template <int N>
__device__ __forceinline__ float warp_scatter(float (&s)[N], int lane,
                                              int& idx) {
  static_assert(N >= 4 && N <= 32 && (N & (N - 1)) == 0,
                "N is a power of two from 4 to 32");
  idx = 0;
  scatter_level<N / 2, N>(s, lane, idx);
  float x = s[0];
#pragma unroll
  for (int o = 32 / N / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Every lane's copy of the N values x that lanes hold by index idx (as
// warp_scatter leaves them), through `scratch` (N floats of this warp).
template <int N>
__device__ __forceinline__ void warp_gather(float x, int idx, float* scratch,
                                            int lane, float (&out)[N]) {
  constexpr int kShare = 32 / N;  // lanes that hold each value
  if ((lane & (kShare - 1)) == 0) scratch[idx] = x;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(scratch + j);
    out[j] = v.x;
    out[j + 1] = v.y;
    out[j + 2] = v.z;
    out[j + 3] = v.w;
  }
  __syncwarp();
}

// Lane `lane`'s EPL dimensions of row g of the group's q, kept in shared
// memory as float32 (G x D), in the layout dim_of gives.
template <int EPL, bool VEC>
__device__ __forceinline__ void q_row(const float* qs, int g, int lane,
                                      int D, float (&out)[EPL]) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int dim = dim_of<VEC, EPL>(lane, e);
    out[e] = dim < D ? qs[g * D + dim] : 0.f;
  }
}

// One consumer warp's share of a tile of nk keys (K rows at kt, V rows at
// vt, in shared memory): steps of U keys, the group's warps interleaved.
// A step takes the G x U scores of the group against its keys in float32,
// then the online softmax in log2 units: t = s k1, or with the softcap c
// t = c1 - c2 / (1 + 2^(s k1)) = log2(e) c tanh(s scale / c), as the
// forward computes it; m <- max(m, t), alpha = 2^(m_old - m), l <- l alpha
// + sum 2^(t - m), acc <- acc alpha + sum 2^(t - m) v.  Every lane holds
// the same scores, m and l, and its own dimensions of acc.  q sits in
// registers (qv), or where it would not fit (q_in_smem) in shared memory
// (qs), read a row at a time; one K or V row is live at a time.
template <typename T, int EPL, int G, bool VEC>
__device__ __forceinline__ void consume_tile(
    const T* kt, const T* vt, int nk, int D, int group,
    const float (&qv)[G][EPL], const float* qs, bool cap, float k1,
    float c1, float c2, float (&m)[G], float (&l)[G], float (&acc)[G][EPL],
    float* scratch, int wi, int lane) {
  constexpr int U = dg::step_keys(G, EPL);
  constexpr int kStride = dg::kGroupWarps * U;
  for (int j = wi * U; j < nk; j += kStride) {
    float s[G * U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kr[EPL];
      if (j + u < nk) {
        smem_row<T, EPL, VEC>(kt + (j + u) * D, lane, D, kr);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float qr[EPL];
        if constexpr (dg::q_in_smem(G, EPL)) {
          q_row<EPL, VEC>(qs, g, lane, D, qr);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) qr[e] = qv[g][e];
        }
        float dot[2] = {0.f, 0.f};  // two chains of EPL / 2
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          dot[e & 1] = fmaf(qr[e], kr[e], dot[e & 1]);
        s[g * U + u] = dot[0] + dot[1];
      }
    }
    // The lane that holds score (g, u) after the reduction takes its
    // softcap and exponent; every lane takes the maxima and the rescale.
    int idx;
    const float x = warp_scatter<G * U>(s, lane, idx);
    const int g_own = idx / U, u_own = idx % U;
    float t = cap ? fmaf(-c2, rcp(1.f + ex2(x * k1)), c1) : x * k1;
    if (j + u_own >= nk) t = -INFINITY;
    warp_gather<G * U>(t, idx, scratch, lane, s);
    float m_own = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[g * U + u]);
      // key j is live, so m_new is finite; the first step's alpha is
      // 2^-inf = 0
      const float m_new = fmaxf(m[g], mx);
      const float alpha = ex2(m[g] - m_new);
      if (alpha != 1.f) {  // the same in every lane
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      }
      l[g] *= alpha;
      m[g] = m_new;
      m_own = g == g_own ? m_new : m_own;
    }
    // p = 2^(t - m) (2^-inf = 0 for keys past nk), then to every lane
    warp_gather<G * U>(ex2(t - m_own), idx, scratch, lane, s);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
#pragma unroll
      for (int u = 0; u < U; ++u) l[g] += s[g * U + u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u >= nk) break;
      float vr[EPL];
      smem_row<T, EPL, VEC>(vt + (j + u) * D, lane, D, vr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= group) break;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(s[g * U + u], vr[e], acc[g][e]);
      }
    }
  }
}

// A consumer warp's walk over its group's tiles of the rank (tiles q, q +
// kGroups, ...): each waited for on its full barrier and released on its
// empty barrier (one arrival per warp of the group).  A tile's kt / vt sit
// at the envelope offset of its first row's address in its slot.
template <typename T, int EPL, int G, bool VEC>
__device__ __forceinline__ void consume(
    const float* qs, const unsigned char* kbase, const unsigned char* vbase,
    const unsigned char* ring, uint32_t full, uint32_t empty,
    const dg::Tile& t, int r0, int n, int D, int group, bool cap, float k1,
    float c1, float c2, float (&m)[G], float (&l)[G], float (&acc)[G][EPL],
    float* scratch, int warp, int lane) {
  float qv[G][EPL];
  if constexpr (!dg::q_in_smem(G, EPL)) {
#pragma unroll
    for (int g = 0; g < G; ++g) q_row<EPL, VEC>(qs, g, lane, D, qv[g]);
  }
  const int row = D * (int)sizeof(T);
  const int ntiles = (n + t.keys - 1) / t.keys;
  const int wi = warp % dg::kGroupWarps;
  for (int i = warp / dg::kGroupWarps; i < ntiles; i += dg::kGroups) {
    const int slot = i % t.slots;
    const int k0 = r0 + i * t.keys;
    const int nk = min(t.keys, r0 + n - k0);
    const uintptr_t ka =
        reinterpret_cast<uintptr_t>(kbase) + (long long)k0 * row;
    const uintptr_t va =
        reinterpret_cast<uintptr_t>(vbase) + (long long)k0 * row;
    const T* kt = reinterpret_cast<const T*>(ring + 2 * slot * t.slot_bytes +
                                             (ka & 15));
    const T* vt = reinterpret_cast<const T*>(
        ring + (2 * slot + 1) * t.slot_bytes + (va & 15));
    mbar_wait(full + 8 * slot, (i / t.slots) & 1);
    consume_tile<T, EPL, G, VEC>(kt, vt, nk, D, group, qv, qs, cap, k1, c1,
                                 c2, m, l, acc, scratch, wi, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }
}

// The producer's load of tile i (keys r0 + i keys .. of this rank, n in
// all) into slot i % slots: once the consumers have released the slot's
// previous tile (the empty barrier's phase before this use; the first
// use passes at once), the full barrier expects the bytes and one bulk
// copy per operand brings the rows, as the 16-byte envelope around them.
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t ring, uint32_t full,
                                          uint32_t empty, const dg::Tile& t,
                                          const unsigned char* kbase,
                                          const unsigned char* vbase, int r0,
                                          int n, int D, int i) {
  const int row = D * (int)sizeof(T);
  const int slot = i % t.slots;
  const int k0 = r0 + i * t.keys;
  const int bytes = min(t.keys, r0 + n - k0) * row;
  const uintptr_t ka = reinterpret_cast<uintptr_t>(kbase) + (long long)k0 * row;
  const uintptr_t va = reinterpret_cast<uintptr_t>(vbase) + (long long)k0 * row;
  const uintptr_t k_lo = ka & ~uintptr_t(15);
  const uintptr_t v_lo = va & ~uintptr_t(15);
  const int k_bytes = (int)(((ka + bytes + 15) & ~uintptr_t(15)) - k_lo);
  const int v_bytes = (int)(((va + bytes + 15) & ~uintptr_t(15)) - v_lo);
  mbar_wait(empty + 8 * slot, ((i / t.slots) & 1) ^ 1);
  mbar_expect_tx(full + 8 * slot, k_bytes + v_bytes);
  bulk_load(ring + 2 * slot * t.slot_bytes, reinterpret_cast<const void*>(k_lo),
            k_bytes, full + 8 * slot);
  bulk_load(ring + (2 * slot + 1) * t.slot_bytes,
            reinterpret_cast<const void*>(v_lo), v_bytes, full + 8 * slot);
}

// One cluster of C blocks per (kv head, batch row): grid (C, Hkv, B),
// cluster (C, 1, 1).  Rank r of the cluster walks the r-th C-th of the
// row's live range [max(0, len - window), min(len, S)), computed here from
// lengths; one producer thread feeds a ring of K/V tiles with bulk copies,
// two groups of four consumer warps take turns at its tiles; the warps'
// states merge in the block's shared memory, then rank 0 merges the ranks'
// (m, l, acc) in rank order through distributed shared memory and writes
// the output.  Nothing else leaves the launch.
template <typename T, int EPL, int G>
__global__ void __launch_bounds__(dg::kThreads, 1)
decode_cluster(const T* __restrict__ q, const T* __restrict__ kc,
               const T* __restrict__ vc, const int* __restrict__ lengths,
               T* __restrict__ out, int Hq, int Hkv, int S, int D,
               int window, int cap, float k1, float c1, float c2, int vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const dg::Tile t = dg::tile(D, (int)sizeof(T), G);
  const dg::Layout lay = dg::layout(t, D, G);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + (((smem_u32(smem_raw) + 127u) & ~127u) - smem_u32(smem_raw));
  const uint32_t ring_s = smem_u32(base);
  const uint32_t full = ring_s + lay.barriers;
  const uint32_t empty = full + 8 * t.slots;
  float* qs = reinterpret_cast<float*>(base + lay.q);

  // this rank's keys [r0, r0 + n)
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int live = max(min(len, S) - lo, 0);
  const int per = (live + C - 1) / C;
  const int r0 = lo + rank * per;
  const int n = max(0, min(lo + live, r0 + per) - r0);

  const long long slice = (long long)(b * Hkv + hk) * S * D;
  const unsigned char* kbase = reinterpret_cast<const unsigned char*>(kc + slice);
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(vc + slice);
  const int ntiles = (n + t.keys - 1) / t.keys;
  const bool producer = warp == dg::kWarps && lane == 0;
  // The producer sets up the barriers and sends the first tiles out (their
  // slots start empty) before q is read.
  if (producer) {
    for (int s = 0; s < t.slots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, dg::kGroupWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(ntiles, t.slots); ++i)
      load_tile<T>(ring_s, full, empty, t, kbase, vbase, r0, n, D, i);
  }
  const T* qg = q + (long long)(b * Hq + hk * group) * D;
  for (int i = threadIdx.x; i < G * D; i += dg::kThreads)
    qs[i] = i < group * D ? to_f(qg[i]) : 0.f;
  __syncthreads();

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  if (warp == dg::kWarps) {
    // Producer: tile i into slot i % slots once the consumers released the
    // slot's tile i - slots.
    if (producer) {
      for (int i = t.slots; i < ntiles; ++i)
        load_tile<T>(ring_s, full, empty, t, kbase, vbase, r0, n, D, i);
    }
  } else {
    float* scratch = reinterpret_cast<float*>(base + lay.scratch) +
                     warp * G * dg::step_keys(G, EPL);
    if (vec)
      consume<T, EPL, G, true>(qs, kbase, vbase, base, full, empty, t, r0, n,
                               D, group, cap != 0, k1, c1, c2, m, l, acc,
                               scratch, warp, lane);
    else
      consume<T, EPL, G, false>(qs, kbase, vbase, base, full, empty, t, r0,
                                n, D, group, cap != 0, k1, c1, c2, m, l, acc,
                                scratch, warp, lane);
  }
  __syncthreads();  // every tile consumed: the ring is free

  // The warps' states, then the block's: over the ring, m and l first.
  float* states = reinterpret_cast<float*>(base + lay.states);
  if (warp < dg::kWarps) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
      float* st = states + (warp * G + g) * (2 + D);
      if (lane == 0) {
        st[0] = m[g];
        st[1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int dim = vec ? dim_of<true, EPL>(lane, e)
                            : dim_of<false, EPL>(lane, e);
        if (dim < D) st[2 + dim] = acc[g][e];
      }
    }
  }
  __syncthreads();
  float* ex = reinterpret_cast<float*>(base + lay.exchange);
  for (int i = threadIdx.x; i < group * D; i += dg::kThreads) {
    const int g = i / D, dim = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < dg::kWarps; ++w)
      mm = fmaxf(mm, states[(w * G + g) * (2 + D)]);
    float a = 0.f, ls = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < dg::kWarps; ++w) {
        const float* st = states + (w * G + g) * (2 + D);
        const float f = ex2(st[0] - mm);  // 0 for a warp with no key
        ls = fmaf(f, st[1], ls);
        a = fmaf(f, st[2 + dim], a);
      }
    }
    ex[2 * G + g * D + dim] = a;
    if (dim == 0) {
      ex[g] = mm;
      ex[G + g] = ls;
    }
  }

  // Rank 0 merges the ranks' states in rank order, each thread reading
  // every rank's m, l and accumulator of its elements at once (one round
  // trip through distributed shared memory); the second sync keeps every
  // block resident until it has read them.
  cluster.sync();
  if (rank == 0) {
    T* og = out + (long long)(b * Hq + hk * group) * D;
    for (int i = threadIdx.x; i < group * D; i += dg::kThreads) {
      const int g = i / D, dim = i % D;
      float rm[dg::kMaxCluster], rl[dg::kMaxCluster], ra[dg::kMaxCluster];
#pragma unroll
      for (int r = 0; r < dg::kMaxCluster; ++r) {
        if (r < C) {
          const float* x = cluster.map_shared_rank(ex, r);
          rm[r] = x[g];
          rl[r] = x[G + g];
          ra[r] = x[2 * G + g * D + dim];
        } else {
          rm[r] = -INFINITY;
          rl[r] = ra[r] = 0.f;
        }
      }
      float mm = -INFINITY;
#pragma unroll
      for (int r = 0; r < dg::kMaxCluster; ++r) mm = fmaxf(mm, rm[r]);
      float a = 0.f, ls = 0.f;
      if (mm != -INFINITY) {  // else no rank saw a key: the row is 0
#pragma unroll
        for (int r = 0; r < dg::kMaxCluster; ++r) {
          const float f = ex2(rm[r] - mm);  // 0 for an empty rank
          ls = fmaf(f, rl[r], ls);
          a = fmaf(f, ra[r], a);
        }
      }
      store(og + g * D + dim, ls > 0.f ? a / ls : 0.f);
    }
  }
  cluster.sync();
}

int epl_for(int D) { return dg::epl_for(D); }

template <typename T, int EPL>
void launch_rows(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                 int window, float softcap, float scale, cudaStream_t s) {
  const dim3 grid((Sq + kWarps - 1) / kWarps, Hq, B);
  fwd_rows<T, EPL><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      causal, window, softcap, scale);
}

template <typename T>
void launch_rows_d(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                   int window, float softcap, float scale, cudaStream_t s) {
  switch (epl_for(D)) {
    case 1: launch_rows<T, 1>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s); break;
    case 2: launch_rows<T, 2>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s); break;
    case 4: launch_rows<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s); break;
    default: launch_rows<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s); break;
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query: no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (slices, rows, D) bf16 tensor as a 3-d tensor map with boxes of
// (64 columns, box_rows rows, 1 slice) under the 128-byte swizzle; rows
// past `rows` in a slice read as zeros.
int tensor_map(CUtensorMap* map, const void* base, int rows, int slices,
               int D, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                 float softcap, float scale, cudaStream_t s) {
  typedef FwdTile<D> T;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, Sq, B * Hq, D, T::kRows);
  if (err == 0) err = tensor_map(&tk, k, Skv, B * Hkv, D, T::kKeys);
  if (err == 0) err = tensor_map(&tv, v, Skv, B * Hkv, D, T::kKeys);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + T::kRows - 1) / T::kRows, Hq, B);
  fwd_wgmma<D><<<grid, kFwdThreads, T::kSmem, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), Hq, Hkv, Sq, Skv, causal, window,
      softcap, scale);
  return 0;
}

// How many clusters of each size c = 1 .. 16 blocks of this decode
// instantiation fit on the current device at once, after the SM count:
// facts[0] = SMs, facts[c] = clusters of c (0 where that size cannot
// launch: above 8 is opt-in and may be refused).  Immutable per device,
// so queried once and kept in statics; the launch attributes they need
// are set with them.
constexpr int kMaxDevices = 64;

template <typename T, int EPL, int G>
int decode_facts(int* facts) {
  static int cache[kMaxDevices][1 + dg::kMaxCluster];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int* c = cache[dev];
  if (__atomic_load_n(&c[0], __ATOMIC_ACQUIRE) == 0) {
    auto kern = decode_cluster<T, EPL, G>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dg::kSmem);
    if (e != cudaSuccess) return (int)e;
    const bool wide = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess;
    if (!wide) cudaGetLastError();
    int f[1 + dg::kMaxCluster];
    e = cudaDeviceGetAttribute(&f[0], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    for (int size = 1; size <= dg::kMaxCluster; ++size) {
      f[size] = 0;
      if (size > 8 && !wide) continue;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = size;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(size, 1, 1);
      cfg.blockDim = dim3(dg::kThreads, 1, 1);
      cfg.dynamicSmemBytes = dg::kSmem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&f[size], kern, &cfg);
      if (e != cudaSuccess) {
        if (size <= 8) return (int)e;  // portable sizes must launch
        cudaGetLastError();
        f[size] = 0;
      }
    }
    for (int i = 1; i <= dg::kMaxCluster; ++i) c[i] = f[i];
    __atomic_store_n(&c[0], f[0], __ATOMIC_RELEASE);
  }
  for (int i = 0; i <= dg::kMaxCluster; ++i) facts[i] = c[i];
  return 0;
}

// The tile and the cluster size of one call: `want` > 0 asks for that
// cluster size (1 .. 16, one the device can launch), 0 for the rule's
// (decode_geometry::cluster_size).
template <typename T, int EPL, int G>
int decode_plan(int D, int S, int B, int Hkv, int want, int* cluster,
                dg::Tile* tile) {
  int facts[1 + dg::kMaxCluster];
  const int e = decode_facts<T, EPL, G>(facts);
  if (e != 0) return e;
  *tile = dg::tile(D, (int)sizeof(T), G);
  if (!dg::fits(*tile, D, G)) return (int)cudaErrorInvalidValue;
  if (want <= 0) {
    *cluster = dg::cluster_size(B * Hkv, S, facts[0], facts + 1);
    return 0;
  }
  if (want > dg::kMaxCluster || facts[want] < 1)
    return (int)cudaErrorInvalidValue;
  *cluster = want;
  return 0;
}

template <typename T, int EPL, int G>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const int* lengths, void* out, int B, int Hq, int Hkv,
                  int S, int D, int window, float softcap, float scale,
                  int want, cudaStream_t s) {
  int C = 1;
  dg::Tile t;
  const int e = decode_plan<T, EPL, G>(D, S, B, Hkv, want, &C, &t);
  if (e != 0) return e;
  const int cap = softcap > 0.f;
  const float k1 = cap ? 2.f * kLog2e * scale / softcap : kLog2e * scale;
  const float c1 = kLog2e * softcap, c2 = 2.f * c1;
  // whole 16-byte vectors where every row starts on a 16-byte boundary
  const int vec = (D * (int)sizeof(T)) % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(kc) |
                    reinterpret_cast<uintptr_t>(vc)) & 15) == 0;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(dg::kThreads, 1, 1);
  cfg.dynamicSmemBytes = dg::kSmem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, decode_cluster<T, EPL, G>, static_cast<const T*>(q),
      static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      static_cast<T*>(out), Hq, Hkv, S, D, window, cap, k1, c1, c2, vec);
}

template <typename T>
struct TypeTag {
  typedef T type;
};
template <int N>
using IntTag = std::integral_constant<int, N>;

// fn(TypeTag<T>, IntTag<EPL>, IntTag<G>) for the decode instantiation that
// serves this dtype, head dim and GQA group.
template <typename Fn>
int with_decode(int dtype, int D, int group, Fn&& fn) {
  const int g = group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
  auto by_g = [&](auto t, auto epl) -> int {
    switch (g) {
      case 1: return fn(t, epl, IntTag<1>{});
      case 2: return fn(t, epl, IntTag<2>{});
      case 4: return fn(t, epl, IntTag<4>{});
      default: return fn(t, epl, IntTag<8>{});
    }
  };
  auto by_epl = [&](auto t) -> int {
    switch (epl_for(D)) {
      case 1: return by_g(t, IntTag<1>{});
      case 2: return by_g(t, IntTag<2>{});
      case 4: return by_g(t, IntTag<4>{});
      default: return by_g(t, IntTag<8>{});
    }
  };
  return dtype == kDtypeBF16 ? by_epl(TypeTag<bf16>{})
                             : by_epl(TypeTag<float>{});
}

bool decode_takes(int D, int group) {
  return D >= 1 && D <= 256 && group >= 1 && group <= 8;
}

}  // namespace

// q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); o: (B, Hq, Sq, D); all
// contiguous, float32 (dtype 0) or bfloat16 (dtype 1).  window <= 0 and
// softcap <= 0 mean none.  Requires Hq % Hkv == 0 and D <= 256 (checked by
// the wrapper).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Sq, int Skv,
                                          int D, int dtype, int causal,
                                          int window, float softcap,
                                          float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Hq == 0 || Sq == 0 || D == 0) return (int)cudaGetLastError();
  if (Skv == 0)  // no key: every row writes 0
    return (int)cudaMemsetAsync(
        o, 0, (size_t)B * Hq * Sq * D * (dtype == kDtypeBF16 ? 2 : 4), s);
  if (dtype == kDtypeBF16) {
    int err = -1;
    // the TMA reads from 16-byte aligned bases (the wrapper provides them)
    if (wgmma_serves(D, dtype) &&
        (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15))
      return (int)cudaErrorMisalignedAddress;
    if (D == 64)
      err = launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, scale, s);
    else if (D == 128)
      err = launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, scale, s);
    else if (D == 256)
      err = launch_wgmma<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, scale, s);
    else
      launch_rows_d<bf16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s);
    if (err > 0) return err;
  } else {
    launch_rows_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s);
  }
  return (int)cudaGetLastError();
}

// The forward's tile at head dim D and dtype: where fwd_wgmma serves it,
// returns 1 and writes the query rows of a block, the keys of a K/V tile
// and the ring's slots per operand; returns 0 where fwd_rows serves it.
extern "C" int flash_attention_fwd_tile(int D, int dtype, int* rows,
                                        int* keys, int* stages) {
  if (!wgmma_serves(D, dtype)) return 0;
  return D == 64    ? report_tile<64>(rows, keys, stages)
         : D == 128 ? report_tile<128>(rows, keys, stages)
                    : report_tile<256>(rows, keys, stages);
}

// q: (B, Hq, D); k_cache, v_cache: (B, Hkv, S, D); lengths: (B,) int32 on
// the device; out: (B, Hq, D); all contiguous, float32 (dtype 0) or
// bfloat16 (dtype 1), any element-aligned base.  window <= 0 and softcap
// <= 0 mean none.  cluster: 0 for the library's cluster size, or a size
// up to 16 that the device can launch.  Requires Hq % Hkv == 0,
// Hq / Hkv <= 8 and D <= 256.  One launch; allocates nothing.
extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* lengths,
                                   void* out, int B, int Hq, int Hkv, int S,
                                   int D, int dtype, int window,
                                   float softcap, float scale, int cluster,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Hq == 0 || D == 0) return (int)cudaGetLastError();
  if (Hkv < 1 || Hq % Hkv != 0 || !decode_takes(D, Hq / Hkv))
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  const int err = with_decode(dtype, D, Hq / Hkv, [&](auto t, auto epl,
                                                      auto g) {
    typedef typename decltype(t)::type T;
    return launch_decode<T, decltype(epl)::value, decltype(g)::value>(
        q, k_cache, v_cache, len, out, B, Hq, Hkv, S, D, window, softcap,
        scale, cluster, s);
  });
  return err != 0 ? err : (int)cudaGetLastError();
}

// The decode geometry a call with these shapes gets on the current device:
// the cluster size (blocks sharing one (batch row, kv head)), the keys of
// a K/V tile and the ring's slots.  Returns 0, or the CUDA error of a
// shape the kernel does not take or a device query that failed.
extern "C" int flash_decode_geometry(int D, int dtype, int group, int S,
                                     int B, int Hkv, int* cluster,
                                     int* keys_per_tile, int* slots) {
  if (!decode_takes(D, group)) return (int)cudaErrorInvalidValue;
  return with_decode(dtype, D, group, [&](auto t, auto epl, auto g) {
    typedef typename decltype(t)::type T;
    int c = 1;
    dg::Tile tile;
    const int e = decode_plan<T, decltype(epl)::value, decltype(g)::value>(
        D, S, B, Hkv, 0, &c, &tile);
    if (e == 0) {
      *cluster = c;
      *keys_per_tile = tile.keys;
      *slots = tile.slots;
    }
    return e;
  });
}
