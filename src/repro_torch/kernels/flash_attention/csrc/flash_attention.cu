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
//   * decode: split-K.  With B = 4 and Hkv = 8 the TPU grid has 32
//     (batch, kv head) programs for 132 SMs, so the live range of each
//     row is cut into n_splits pieces (chosen by the wrapper from the SM
//     count), one block each.  A block loads the q vectors of the whole
//     GQA group that shares its kv head, so each K/V row is read once
//     for the group; its 4 warps take every fourth key, and their states
//     merge in shared memory into one partial (m, l, acc) per split,
//     written to scratch the wrapper allocates.  decode_combine merges the
//     splits.  lengths is read on the device: no host sync per step.
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
// TB/s).
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream, do not synchronise and allocate nothing; each entry
// point returns cudaGetLastError() so a refused launch surfaces at once.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDtypeBF16 = 1;
constexpr int kThreads = 128;  // 4 warps in fwd_rows and decode
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // keys loaded per warp step (FMA paths)
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

// One warp's online softmax over keys lo, lo + step, ... < hi for the G
// query vectors q[0 .. group) that share these K/V rows.  (m, l, acc) carry
// the running max, the running sum of exp(s - m) and the unnormalised
// output; every lane holds the same m and l, and its own dimensions of acc.
template <typename T, int EPL, int G>
__device__ __forceinline__ void attend(const float (&q)[G][EPL], int group,
                                       const T* __restrict__ kb,
                                       const T* __restrict__ vb, int D,
                                       int lo, int hi, int step, float scale,
                                       float softcap, float (&m)[G],
                                       float (&l)[G], float (&acc)[G][EPL]) {
  const int lane = threadIdx.x & 31;
  for (int j = lo; j < hi; j += kUnroll * step) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = j + u * step;
      ok[u] = key < hi;
      if (ok[u]) {
        load_row<T, EPL>(kb + (long long)key * D, lane, D, kr[u]);
        load_row<T, EPL>(vb + (long long)key * D, lane, D, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
      float s[kUnroll];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(q[g][e], kr[u][e], dot);
        dot = apply_cap(warp_sum(dot) * scale, softcap);
        s[u] = ok[u] ? dot : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = __expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = __expf(s[u] - m_new);  // exp(-inf) = 0: masked keys
        psum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
    }
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
  float qv[1][EPL];
  load_row<T, EPL>(q + qrow, lane, D, qv[0]);
  const int lo = window > 0 ? max(0, row - window + 1) : 0;
  const int hi = causal ? min(Skv, row + 1) : Skv;
  float m[1] = {kNegInf}, l[1] = {0.f}, acc[1][EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[0][e] = 0.f;
  attend<T, EPL, 1>(qv, 1, k + kvbase, v + kvbase, D, lo, hi, 1, scale,
                    softcap, m, l, acc);
  const float inv = l[0] > 0.f ? 1.f / l[0] : 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int dim = lane * EPL + e;
    if (dim < D) store(o + qrow + dim, acc[0][e] * inv);
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
// Split-K decode.
// ---------------------------------------------------------------------------

// One block per (split, kv head, batch row).  Writes the split's partial
// (m, l, acc) for each q head of the group to pm / pl: (B, Hq, n_splits)
// and pacc: (B, Hq, n_splits, D).
template <typename T, int EPL, int G>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ lengths,
             float* __restrict__ pm, float* __restrict__ pl,
             float* __restrict__ pacc, int Hq, int Hkv, int S, int D,
             int window, float softcap, float scale, int n_splits) {
  extern __shared__ float ws[];  // [kWarps][G][2 + D]: m, l, acc per warp
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int hi = min(len, S);
  const int live = max(hi - lo, 0);
  const int per = (live + n_splits - 1) / n_splits;
  const int s0 = lo + split * per;
  const int s1 = min(hi, s0 + per);

  float qv[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      load_row<T, EPL>(q + (long long)(b * Hq + hk * group + g) * D, lane, D,
                       qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[g][e] = 0.f;
    }
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  const long long kvbase = (long long)(b * Hkv + hk) * S * D;
  attend<T, EPL, G>(qv, group, kc + kvbase, vc + kvbase, D, s0 + warp, s1,
                    kWarps, scale, softcap, m, l, acc);

  const int row = 2 + D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= group) break;
    float* w = ws + (warp * G + g) * row;
    if (lane == 0) {
      w[0] = m[g];
      w[1] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int dim = lane * EPL + e;
      if (dim < D) w[2 + dim] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int g = i / D, dim = i % D;
    float mmax = kNegInf;
    for (int w = 0; w < kWarps; ++w) mmax = fmaxf(mmax, ws[(w * G + g) * row]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* x = ws + (w * G + g) * row;
      const float f = __expf(x[0] - mmax);
      lsum += x[1] * f;
      a += x[2 + dim] * f;
    }
    const long long bh = (long long)b * Hq + hk * group + g;
    pacc[(bh * n_splits + split) * D + dim] = a;
    if (dim == 0) {
      pm[bh * n_splits + split] = mmax;
      pl[bh * n_splits + split] = lsum;
    }
  }
}

// One block per (batch row, q head): merge the splits' partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ pm, const float* __restrict__ pl,
               const float* __restrict__ pacc, T* __restrict__ out, int D,
               int n_splits) {
  const long long bh = blockIdx.x;
  const float* m = pm + bh * n_splits;
  const float* l = pl + bh * n_splits;
  float mmax = kNegInf;
  for (int s = 0; s < n_splits; ++s) mmax = fmaxf(mmax, m[s]);
  float lsum = 0.f;
  for (int s = 0; s < n_splits; ++s) lsum += l[s] * __expf(m[s] - mmax);
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  for (int dim = threadIdx.x; dim < D; dim += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a += pacc[(bh * n_splits + s) * D + dim] * __expf(m[s] - mmax);
    store(out + bh * D + dim, a * inv);
  }
}

int epl_for(int D) { return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8; }

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

template <typename T, int EPL, int G>
void launch_split(const void* q, const void* kc, const void* vc,
                  const int* lengths, float* pm, float* pl, float* pacc,
                  int B, int Hq, int Hkv, int S, int D, int window,
                  float softcap, float scale, int n_splits, cudaStream_t s) {
  const dim3 grid(n_splits, Hkv, B);
  const size_t bytes = (size_t)kWarps * G * (2 + D) * sizeof(float);
  decode_split<T, EPL, G><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, pm, pl, pacc, Hq, Hkv, S, D, window,
      softcap, scale, n_splits);
}

template <typename T, int EPL>
void launch_split_g(int gmax, const void* q, const void* kc, const void* vc,
                    const int* lengths, float* pm, float* pl, float* pacc,
                    int B, int Hq, int Hkv, int S, int D, int window,
                    float softcap, float scale, int n_splits, cudaStream_t s) {
  switch (gmax) {
    case 1: launch_split<T, EPL, 1>(q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
    case 2: launch_split<T, EPL, 2>(q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
    case 4: launch_split<T, EPL, 4>(q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
    default: launch_split<T, EPL, 8>(q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
  }
}

template <typename T>
void launch_decode(const void* q, const void* kc, const void* vc,
                   const int* lengths, void* out, float* pm, float* pl,
                   float* pacc, int B, int Hq, int Hkv, int S, int D,
                   int window, float softcap, float scale, int n_splits,
                   cudaStream_t s) {
  const int group = Hq / Hkv;
  const int gmax = group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
  switch (epl_for(D)) {
    case 1: launch_split_g<T, 1>(gmax, q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
    case 2: launch_split_g<T, 2>(gmax, q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
    case 4: launch_split_g<T, 4>(gmax, q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
    default: launch_split_g<T, 8>(gmax, q, kc, vc, lengths, pm, pl, pacc, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s); break;
  }
  decode_combine<T><<<B * Hq, kThreads, 0, s>>>(pm, pl, pacc,
                                                static_cast<T*>(out), D,
                                                n_splits);
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
// the device; out: (B, Hq, D); pm, pl: (B, Hq, n_splits) and pacc:
// (B, Hq, n_splits, D) float32 scratch.  Requires Hq % Hkv == 0,
// Hq / Hkv <= 8, D <= 256 and n_splits >= 1 (checked by the wrapper).
extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* lengths,
                                   void* out, void* pm, void* pl, void* pacc,
                                   int B, int Hq, int Hkv, int S, int D,
                                   int dtype, int window, float softcap,
                                   float scale, int n_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Hq == 0 || D == 0) return (int)cudaGetLastError();
  const int* len = static_cast<const int*>(lengths);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* a = static_cast<float*>(pacc);
  if (dtype == kDtypeBF16)
    launch_decode<bf16>(q, k_cache, v_cache, len, out, m, l, a, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s);
  else
    launch_decode<float>(q, k_cache, v_cache, len, out, m, l, a, B, Hq, Hkv, S, D, window, softcap, scale, n_splits, s);
  return (int)cudaGetLastError();
}
