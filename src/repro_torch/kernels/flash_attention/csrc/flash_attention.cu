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
//   * fwd_mma (bfloat16, D in {64, 128, 256}): one block of 4 warps per
//     (64-row q tile, q head, batch); each warp owns 16 query rows.  The
//     block walks 64-key K/V tiles from the first to the last tile the
//     tile's rows can see (the causal triangle and the window bound the
//     range; fully masked tiles are never visited), staging Q, K and V in
//     shared memory (3 x 64 x (D + 8) bf16 = 101 KB at D = 256, so the
//     opt-in attribute is set before the launch; the 8-element pad spreads
//     rows over the banks).  Q K^T and P V run on the tensor cores as
//     mma.sync.m16n8k16 bf16 -> float32; the softmax stays in registers
//     (the score fragment of Q K^T is reused as the A fragment of P V, so
//     P is rounded to bfloat16 before the product, where the TPU kernel
//     multiplies in float32).  The ragged edge is masked per element, so
//     any Sq and Skv work.  q tiles are launched latest-first, so the
//     longest causal rows start first.
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
// and o.  Decode is byte-bound: it reads each live cache row of K and V
// once (67 MB per global layer at B = 1, len = 8192, D = 256: 0.020 ms at
// 3.35 TB/s).  This first version uses mma.sync with synchronous tile
// loads; wgmma, TMA and warp specialisation are later work.
//
// Interface: plain C, loaded with ctypes.  The kernels launch on the
// caller's stream, do not synchronise and allocate nothing; each entry
// point returns cudaGetLastError() so a refused launch surfaces at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDtypeBF16 = 1;
constexpr int kThreads = 128;  // 4 warps in every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // q rows and keys per tile in fwd_mma
constexpr int kPad = 8;        // bf16 elements of padding per smem row
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
// Forward, bfloat16 tensor-core path.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + kTile) of a (rows, D) bf16 matrix into a padded smem
// tile, 16 bytes per thread per step; rows at or past `rows` read 0.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + kPad;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * D +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): with g = lane / 4
// and t = lane % 4, A register r holds row g + 8 * (r & 1), columns
// 2t + 8 * (r >> 1) and +1; B register r holds rows (k) 2t + 8r and +1 of
// column (n) g; the float32 C/D fragment holds rows g (c0, c1) and g + 8
// (c2, c3) at columns 2t and 2t + 1.
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, bf16* __restrict__ o, int Hq, int Hkv,
        int Sq, int Skv, int causal, int window, float softcap, float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kN = D / 8;  // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * kLd;
  bf16* vs = ks + kTile * kLd;
  const unsigned short* vs16 = reinterpret_cast<const unsigned short*>(vs);

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTile;  // latest tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + (long long)(b * Hq + h) * Sq * D;
  const bf16* kb = k + (long long)(b * Hkv + hk) * Skv * D;
  const bf16* vb = v + (long long)(b * Hkv + hk) * Skv * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;              // the warp's rows in the tile
  const int qa = q0 + wrow + g, qb_ = qa + 8;  // this thread's two rows

  load_tile<D>(qs, qb, q0, Sq);

  int lo = 0, hi = Skv;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(Skv, q0 + kTile);

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int k0 = (lo / kTile) * kTile; k0 < hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, kb, k0, Skv);
    load_tile<D>(vs, vb, k0, Skv);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qr = qs + (wrow + g) * kLd + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(qr), a1 = ld32(qr + 8 * kLd);
      const uint32_t a2 = ld32(qr + 8), a3 = ld32(qr + 8 * kLd + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kr = ks + (j * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    // scale, softcap, mask; row max over the quad that shares a row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? qa : qb_;
        const bool live = kp < Skv && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        const float x = apply_cap(s[j][e] * scale, softcap);
        s[j][e] = live ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];  // a per-thread partial sum; the quad adds at the end
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_r[e >> 1]);  // masked: exp(-inf) = 0
        l_r[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's score fragments become A fragments, 4 k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int r0 = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int c = n * 8 + g;
        const uint32_t b0 = (uint32_t)vs16[r0 * kLd + c] |
                            ((uint32_t)vs16[(r0 + 1) * kLd + c] << 16);
        const uint32_t b1 = (uint32_t)vs16[(r0 + 8) * kLd + c] |
                            ((uint32_t)vs16[(r0 + 9) * kLd + c] << 16);
        mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;
  }
  bf16* ob = o + (long long)(b * Hq + h) * Sq * D;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 8 + 2 * t;
    if (qa < Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)qa * D + c) =
          pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (qb_ < Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)qb_ * D + c) =
          pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Skv, int causal, int window,
               float softcap, float scale, cudaStream_t s) {
  const int bytes = 3 * kTile * (D + kPad) * (int)sizeof(bf16);
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  fwd_mma<D><<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Sq, Skv,
      causal, window, softcap, scale);
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
  if (dtype == kDtypeBF16) {
    int err = -1;
    if (D == 64)
      err = launch_mma<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, scale, s);
    else if (D == 128)
      err = launch_mma<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, scale, s);
    else if (D == 256)
      err = launch_mma<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, softcap, scale, s);
    else
      launch_rows_d<bf16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s);
    if (err > 0) return err;
  } else {
    launch_rows_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, scale, s);
  }
  return (int)cudaGetLastError();
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
