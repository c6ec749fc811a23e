// mamba_scan.cu — the Mamba-1 selective scan as one hand-written CUDA
// kernel for Hopper (sm_90a), parallel over time.
//
// Replaces repro/kernels/mamba_scan/kernel.py::_scan_kernel (the Pallas TPU
// kernel behind selective_scan).  It computes what the reference's oracle
// ref.py::selective_scan_ref computes, with float32 arithmetic inside:
//   h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) B_t      (D x N)
//   y_t = <h_t, C_t> + D * u_t                                   (D)
// for u, delta (batch, L, D), A (D, N), B, C (batch, L, N), D (D,).  y is
// written in u's dtype, rounded once after D*u is added in float32 (the
// TPU kernel rounds y first and adds D*u in the input dtype); the final
// state h_L is written once, float32, laid out (batch, D, N).
//
// Design.  The recurrence is associative: the step h <- a*h + b composes
// as (a1, b1) then (a2, b2) = (a1*a2, a2*b1 + b2), so time splits across
// lanes as in Mamba's own CUDA scan (arXiv:2312.00752):
//   * a block owns kCh = 32 channels of one batch row: 8 warps of 4
//     channels, kSeg = 8 lanes a channel; the grid is (ceil(D / 32),
//     batch), 256 blocks at D = 8192, all resident at two an SM;
//   * the block walks L in chunks of kT = kSeg * kItems = 64 steps; lane s
//     of a channel owns the kItems = 8 consecutive steps 8s .. 8s + 7;
//   * per group of kGroup = 2 states (one float2 of B and of C), a lane
//     forms dA = exp(delta*A) and dBu = (delta*u) B for its steps, keeps
//     the 32 factors in registers and folds them into a pair (P, h): the
//     product of its dA and the state its segment reaches; the channel's
//     first lane folds from the chunk's carry, the others from zero;
//   * an inclusive scan of (P, h) over the channel's 8 lanes
//     (Hillis-Steele, three levels of __shfl_up_sync of width 8; the last
//     level needs no P) gives each lane the true state at the end of its
//     segment, and one more shuffle the state at its start;
//   * each lane walks its steps again from that state with the stored
//     factors and adds h * C into its y partials; the last lane's last
//     state is the next chunk's carry, and the last chunk's is h_final.
// So each thread's sequential chain is kItems steps and three scan levels
// a chunk, not L steps, and the kernel makes exactly one exp2 a (t, d, n)
// element of the input: the walk reuses the stored factors; steps past L,
// states past N and channels past D enter as the identity (dA = 1, dBu =
// 0) without one, on a masked copy of the fold that only a ragged chunk,
// group or block takes.  Four channels a warp, not one: B and C are read
// once a block for 32 channels (a quarter of the L2 traffic of 8), each of
// their shared-memory reads serves four lanes, and the scan has three
// levels, not five.
//
// Staging.  Each chunk goes through shared memory twice:
//   * raw tiles in the input dtype, as the rows lie in memory: u and delta
//     [kT][32 + a 16-byte pad], B and C [kT][16], two chunks deep.  Where
//     every row starts on a 16-byte boundary (kVec) they arrive by cp.async
//     (16-byte pieces, the ragged edges zero-filled through the copy's
//     source size), issued two chunks ahead, so they land under the walks
//     before; otherwise by plain loads.  B and C are read through their
//     own batch and time strides, so the model's column slices need no
//     copy;
//   * a staging pass turns them into float32 tiles laid out for the lanes:
//     per channel a row of delta and of delta*u at position t + 4 (t / 32),
//     B and C as float2 pairs at 8t + q + t / 8 (pad once a lane segment),
//     and D*u in a row-major tile [kT][33], which the lanes add last to
//     their sum of <h, C> (the plain version's order).  Bank conflicts,
//     the choice made for each: a lane reads its 8 steps of delta and
//     delta*u as two float4 (quarter-warps touch eight distinct 16-byte
//     bank groups); its pair of B or C as one float2 shared by the 4 lanes
//     of a segment (the 8 segments at pairs 65 s + 8 i + g: distinct);
//     its y column at stride 33 (8 s + channel: distinct).  The staging
//     pass reads padded raw rows (stride 9 or 5 16-byte units) and writes
//     consecutive addresses.  Columns read straight out of the raw tiles
//     would be 8- to 32-way conflicts: lanes 8 rows apart.
//   * y leaves through the row-major tile (double-buffered), as 16-byte
//     pieces with consecutive threads on consecutive pieces of a row, in
//     the next chunk's staging pass.
// Shared memory: 101 KB a block at float32 (77 KB at bfloat16), so two
// blocks (16 warps) fit an SM beside at most 128 registers a thread.
//
// exp(delta*A) is ex2.approx.ftz(delta * A*log2(e)), A scaled once: the
// special-function unit's one instruction, equal to exp2f wherever the
// result is a normal float (below 2^-126 it flushes to 0, which the state
// cannot tell from a subnormal); the product with the pre-scaled A adds
// half an ulp of its argument.
//
// What bounds it on an H100.  At the main shape (batch 1, L = D = 8192, N =
// 16, float32) L*D*N = 1.07e9 exp2 calls on the special-function units (16
// a clock per SM) take 0.26 ms at 1.98 GHz; the bytes (each input read
// once, y written once: 0.81 GB) 0.24 ms at 3.35 TB/s.  Issue is tighter
// than either: an element costs about 12 warp instructions (the exp2 and
// its argument, dBu, the fold's multiply and multiply-add, the walk's two
// multiply-adds, a B and a C read a pair, about 2.5 amortised scan
// operations and the group's bookkeeping), 0.44 ms at four instructions a
// clock on 132 SMs at 1.755 GHz.  The walk issues below that rate, its
// warps stalled on the shuffle and multiply-add chains (PERF.md has the
// card's readings).  The old channel-parallel walk (every thread through
// all L steps) was limited by one block's step latency instead.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, does not synchronise and allocates nothing; the entry
// point returns cudaGetLastError() so a refused launch surfaces at once.
// mamba_scan_tile reports the chunk geometry, mamba_scan_blocks_per_sm the
// occupancy the launch gets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 8;                   // lanes (time segments) a channel
constexpr int kChW = 32 / kSeg;           // channels a warp (4)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;     // 256
constexpr int kCh = kWarps * kChW;        // channels a block (32)
constexpr int kItems = 8;                 // consecutive steps a lane owns
constexpr int kT = kSeg * kItems;         // steps a chunk (64)
constexpr int kGroup = 2;                 // states scanned together
constexpr int kMaxN = 16;
constexpr int kPairs = kMaxN / kGroup;    // float2 pairs of B or C a step
constexpr int kRow = kT + kT / 8;         // a lane-layout channel row
constexpr int kBcPairs = kT * kPairs + kT / 8;
constexpr int kOctets = kCh / 8;          // 8-channel pieces of a row
constexpr int kYRow = kCh + 1;            // a y row, padded
constexpr int kDtypeBF16 = 1;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kT * kOctets == kThreads,
              "the staging pass gives a thread 8 channels of one step");
static_assert(kItems == 8, "pair_pos pads once a lane segment of 8 steps");

__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// bfloat16 pairs packed in a 32-bit word, low half first
__device__ __forceinline__ float lo_f(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// eight consecutive elements (16-byte aligned) to float32, and back
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = lo_f(w[k]);
    v[2 * k + 1] = hi_f(w[k]);
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
// a group's two states: unpacked, and two elements (aligned to two) to
// float32
static_assert(kGroup == 2, "a group of states is one float2");
__device__ __forceinline__ void unpack(const float2& v, float (&o)[2]) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ float2 load_group(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_group(const __nv_bfloat16* p) {
  const unsigned x = *reinterpret_cast<const unsigned*>(p);
  return make_float2(lo_f(x), hi_f(x));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// lane-layout positions: step t of a channel row, pair q of step t
__device__ __forceinline__ int row_pos(int t) { return t + 4 * (t >> 5); }
__device__ __forceinline__ int pair_pos(int t, int q) {
  return kPairs * t + q + (t >> 3);
}

template <typename T>
struct Raw {                      // one chunk as the rows lie in memory
  static constexpr int kPad = 16 / sizeof(T);   // a 16-byte pad a u row
  static constexpr int kUdRow = kCh + kPad;
  T u[kT * kUdRow];
  T d[kT * kUdRow];
  T b[kT * kMaxN];
  T c[kT * kMaxN];
};

template <typename T>
struct Smem {
  Raw<T> raw[2];                  // chunks k + 1, k + 2 land under walk k
  float2 bq[kBcPairs];            // lane layout, float32
  float2 cq[kBcPairs];
  float dl[kCh * kRow];           // delta
  float dul[kCh * kRow];          // delta * u
  float yr[2][kT * kYRow];        // y, row-major: D * u, then y
  float a2[kCh * kMaxN];          // A * log2(e), 0 past N
  float carry[kCh * kMaxN];       // the state entering the next chunk
  float dskip[kCh];
};

template <typename T>
constexpr int smem_bytes() { return (int)sizeof(Smem<T>); }

// Issues chunk t0's raw tiles into r: u and delta rows of the block's kCh
// channels (ub, db: the block's first channel of row 0 of its batch row),
// B and C rows; zero past L, D and N.  Each thread copies fixed pieces.
template <typename T, bool kVec>
__device__ __forceinline__ void issue_chunk(
    Raw<T>& r, const T* __restrict__ ub, const T* __restrict__ db,
    const T* __restrict__ bb, const T* __restrict__ cb, int t0, int L, int D,
    int N, int c0, long long b_sl, long long c_sl, int tid) {
  constexpr int kRowLen = Raw<T>::kUdRow;
  constexpr int es = sizeof(T);
  if constexpr (kVec) {
    constexpr int kPer = 16 / es;                  // elements a piece
    constexpr int kUdPieces = kCh / kPer;          // pieces a u row
    constexpr int kBcPieces = kMaxN / kPer;        // pieces a B row
    constexpr int kUdEach = kT * kUdPieces / kThreads;
    constexpr int kBcAll = kT * kBcPieces;
    static_assert(kUdEach * kThreads == kT * kUdPieces && kBcAll <= kThreads,
                  "whole pieces a thread");
#pragma unroll
    for (int m = 0; m < kUdEach; ++m) {
      const int e = tid + kThreads * m;
      const int t = e / kUdPieces, ch = (e % kUdPieces) * kPer;
      const int n = t0 + t < L ? min(max(D - c0 - ch, 0), kPer) : 0;
      const long long at = n ? (long long)(t0 + t) * D + ch : 0;
      cp_async16(&r.u[t * kRowLen + ch], ub + at, n * es);
      cp_async16(&r.d[t * kRowLen + ch], db + at, n * es);
    }
    if (tid < kBcAll) {
      const int t = tid / kBcPieces, k = (tid % kBcPieces) * kPer;
      const int n = t0 + t < L ? min(max(N - k, 0), kPer) : 0;
      const long long tt = n ? t0 + t : 0;
      cp_async16(&r.b[t * kMaxN + k], bb + (n ? tt * b_sl + k : 0), n * es);
      cp_async16(&r.c[t * kMaxN + k], cb + (n ? tt * c_sl + k : 0), n * es);
    }
  } else {
    for (int e = tid; e < kT * kCh; e += kThreads) {
      const int t = e / kCh, ch = e % kCh;
      const bool ok = t0 + t < L && c0 + ch < D;
      const long long at = (long long)(t0 + t) * D + ch;
      r.u[t * kRowLen + ch] = ok ? ub[at] : zero<T>();
      r.d[t * kRowLen + ch] = ok ? db[at] : zero<T>();
    }
    for (int e = tid; e < kT * kMaxN; e += kThreads) {
      const int t = e / kMaxN, k = e % kMaxN;
      const bool ok = t0 + t < L && k < N;
      const long long tt = t0 + t;
      r.b[e] = ok ? bb[tt * b_sl + k] : zero<T>();
      r.c[e] = ok ? cb[tt * c_sl + k] : zero<T>();
    }
  }
}

// The fold of one lane's segment for one group of states: the factors
// dA = exp(delta*A) and dBu = (delta*u) B of its steps, their product P
// and the state h they carry it to.  B of step i lies at brow[kPairs * i]
// (pair_pos pads once a segment).  kMask: only the first `steps` steps
// and `states` states are real; the rest enter as the identity without an
// exp2.
template <bool kMask>
__device__ __forceinline__ void fold(const float (&dt)[kItems],
                                     const float (&du)[kItems],
                                     const float (&a2)[kGroup],
                                     const float2* brow, int steps,
                                     int states,
                                     float (&dA)[kItems][kGroup],
                                     float (&dBu)[kItems][kGroup],
                                     float (&P)[kGroup], float (&h)[kGroup]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    float b[kGroup];
    unpack(brow[kPairs * i], b);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      dA[i][j] = (!kMask || (i < steps && j < states)) ? ex2(dt[i] * a2[j])
                                                       : 1.f;
      dBu[i][j] = du[i] * b[j];
      h[j] = fmaf(dA[i][j], h[j], dBu[i][j]);
      P[j] *= dA[i][j];
    }
  }
}

// Writes chunk t0's y (in yr, row-major) to y as 16-byte pieces of a row,
// consecutive threads on consecutive pieces.
template <typename T, bool kVec>
__device__ __forceinline__ void write_y(const float* __restrict__ yr,
                                        T* __restrict__ yb, int t0, int L,
                                        int D, int c0, int tid) {
  constexpr int kPer = 16 / sizeof(T);           // channels a piece
  constexpr int kPieces = kCh / kPer;            // pieces a row
  static_assert(kT * kPieces % kThreads == 0, "whole pieces a thread");
#pragma unroll
  for (int m = 0; m < kT * kPieces / kThreads; ++m) {
    const int e = tid + kThreads * m;
    const int t = e / kPieces, c = (e % kPieces) * kPer;
    if (t0 + t >= L) continue;
    const float* src = &yr[t * kYRow + c];
    T* dst = yb + (long long)(t0 + t) * D + c;
    if (kVec && c0 + c + kPer <= D) {
      float out[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[j] = src[j];
      if constexpr (kPer == 8) {
        store8(dst, out);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2],
                                                      out[3]);
      }
    } else {
      for (int j = 0; j < kPer && c0 + c + j < D; ++j) from_f(dst + j, src[j]);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
scan_fwd(const T* __restrict__ u, const T* __restrict__ delta,
         const float* __restrict__ A, const T* __restrict__ Bm,
         const T* __restrict__ Cm, const float* __restrict__ Dv,
         T* __restrict__ y, float* __restrict__ h_out, int L, int D, int N,
         long long b_sb, long long b_sl, long long c_sb, long long c_sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& s = *reinterpret_cast<Smem<T>*>(smem_raw);
  constexpr int kRowLen = Raw<T>::kUdRow;

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int seg = lane % kSeg;              // this lane's time segment
  const int cw = w * kChW + lane / kSeg;    // its channel in the block
  const int c0 = blockIdx.x * kCh;
  const int batch = blockIdx.y;
  const bool live = c0 + cw < D;            // this lane's channel exists
  const bool warp_live = c0 + w * kChW < D;
  const int groups = (N + kGroup - 1) / kGroup;
  const int st = tid % kT, oct = tid / kT;  // staging: a step, 8 channels

  for (int e = tid; e < kCh * kMaxN; e += kThreads) {
    const int ch = e / kMaxN, n = e % kMaxN;
    s.a2[e] = (c0 + ch < D && n < N) ? A[(long long)(c0 + ch) * N + n] * kLog2e
                                     : 0.f;
    s.carry[e] = 0.f;
  }
  if (tid < kCh) s.dskip[tid] = c0 + tid < D ? Dv[c0 + tid] : 0.f;

  const long long row0 = (long long)batch * L;   // first (batch, t) row
  const T* bb = Bm + batch * b_sb;
  const T* cb = Cm + batch * c_sb;
  const T* ub = u + row0 * D + c0;               // the block's first channel
  const T* db = delta + row0 * D + c0;
  T* yb = y + row0 * D + c0;
  const int chunks = (L + kT - 1) / kT;

  issue_chunk<T, kVec>(s.raw[0], ub, db, bb, cb, 0, L, D, N, c0, b_sl, c_sl,
                       tid);
  cp_async_commit();
  if (chunks > 1)
    issue_chunk<T, kVec>(s.raw[1], ub, db, bb, cb, kT, L, D, N, c0, b_sl,
                         c_sl, tid);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * kT;
    Raw<T>& r = s.raw[k & 1];
    cp_async_wait_but_one();
    __syncthreads();  // chunk k's raw tiles are in; the walk of k - 1 is done

    // staging: step st of the chunk, channels 8 oct .. 8 oct + 7 (first the
    // chunk before's y there)
    {
      if (k > 0) write_y<T, kVec>(s.yr[(k - 1) & 1], yb, t0 - kT, L, D, c0, tid);
      float uu[8], dd[8];
      load8(&r.u[st * kRowLen + 8 * oct], uu);
      load8(&r.d[st * kRowLen + 8 * oct], dd);
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        const int c = 8 * oct + ch;
        const int at = c * kRow + row_pos(st);
        s.dl[at] = dd[ch];
        s.dul[at] = dd[ch] * uu[ch];
        s.yr[k & 1][st * kYRow + c] = s.dskip[c] * uu[ch];
      }
#pragma unroll
      for (int e = tid; e < kT * kPairs; e += kThreads) {
        const int tt = e / kPairs, q = e % kPairs;
        s.bq[pair_pos(tt, q)] = load_group(&r.b[tt * kMaxN + q * kGroup]);
        s.cq[pair_pos(tt, q)] = load_group(&r.c[tt * kMaxN + q * kGroup]);
      }
    }
    __syncthreads();  // the lane tiles are ready; raw[k & 1] is free
    if (k + 2 < chunks)
      issue_chunk<T, kVec>(r, ub, db, bb, cb, t0 + 2 * kT, L, D, N, c0, b_sl,
                           c_sl, tid);
    cp_async_commit();

    if (!warp_live) continue;
    // the walk: steps kItems * seg .. + kItems - 1 of channel cw
    const int t_first = kItems * seg;
    const int steps = live ? L - t0 - t_first : 0;   // of this lane's in L
    float* ycol = &s.yr[k & 1][t_first * kYRow + cw];
    float dt[kItems], du[kItems], yacc[kItems];
    load8(&s.dl[cw * kRow + row_pos(t_first)], dt);
    load8(&s.dul[cw * kRow + row_pos(t_first)], du);
#pragma unroll
    for (int i = 0; i < kItems; ++i) yacc[i] = 0.f;   // <h, C>, group by group
    for (int g = 0; g < groups; ++g) {
      float a2[kGroup], carry[kGroup];
      unpack(*reinterpret_cast<const float2*>(&s.a2[cw * kMaxN + g * kGroup]),
             a2);
      unpack(*reinterpret_cast<const float2*>(
                 &s.carry[cw * kMaxN + g * kGroup]),
             carry);
      const float2* brow = &s.bq[pair_pos(t_first, g)];
      const float2* crow = &s.cq[pair_pos(t_first, g)];
      float dA[kItems][kGroup], dBu[kItems][kGroup];
      float P[kGroup], h[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        P[j] = 1.f;
        h[j] = seg == 0 ? carry[j] : 0.f;
      }
      // the fold: this lane's segment from zero (the first: from the carry)
      if (steps >= kItems && (g + 1) * kGroup <= N)
        fold<false>(dt, du, a2, brow, kItems, kGroup, dA, dBu, P, h);
      else
        fold<true>(dt, du, a2, brow, steps, N - g * kGroup, dA, dBu, P, h);
      // inclusive scan over the channel's lanes: (P, h) <- (P_prev * P,
      // P * h_prev + h), the identity where no lane lies `off` before;
      // the last level needs no P
#pragma unroll
      for (int off = 1; off < kSeg; off <<= 1) {
        const bool take = seg >= off;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          float hp = __shfl_up_sync(0xffffffffu, h[j], off, kSeg);
          hp = take ? hp : 0.f;
          if (2 * off < kSeg) {
            float pp = __shfl_up_sync(0xffffffffu, P[j], off, kSeg);
            pp = take ? pp : 1.f;
            h[j] = fmaf(P[j], hp, h[j]);
            P[j] *= pp;
          } else {
            h[j] = fmaf(P[j], hp, h[j]);
          }
        }
      }
      // the walk again from the state at the segment's start
      float hs[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float prev = __shfl_up_sync(0xffffffffu, h[j], 1, kSeg);
        hs[j] = seg == 0 ? carry[j] : prev;
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        float cc[kGroup];
        unpack(crow[kPairs * i], cc);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          hs[j] = fmaf(dA[i][j], hs[j], dBu[i][j]);
          yacc[i] = fmaf(hs[j], cc[j], yacc[i]);
        }
      }
      __syncwarp();   // every lane has read this group's carry
      if (seg == kSeg - 1)
        *reinterpret_cast<float2*>(&s.carry[cw * kMaxN + g * kGroup]) =
            make_float2(hs[0], hs[1]);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i)   // + D * u last, as the plain version
      ycol[i * kYRow] = yacc[i] + ycol[i * kYRow];
  }
  __syncthreads();
  write_y<T, kVec>(s.yr[(chunks - 1) & 1], yb, (chunks - 1) * kT, L, D, c0,
                   tid);
  if (live) {
#pragma unroll
    for (int j = 0; j < kMaxN / kSeg; ++j) {
      const int n = seg * (kMaxN / kSeg) + j;
      if (n < N)
        h_out[((long long)batch * D + c0 + cw) * N + n] =
            s.carry[cw * kMaxN + n];
    }
  }
}

template <typename T, bool kVec>
int launch(const void* u, const void* delta, const float* A, const void* B,
           const void* C, const float* Dv, void* y, float* h_out, int batch,
           int L, int D, int N, long long b_sb, long long b_sl,
           long long c_sb, long long c_sl, cudaStream_t s) {
  const int bytes = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      scan_fwd<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_fwd<T, kVec>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((D + kCh - 1) / kCh, batch);
  scan_fwd<T, kVec><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), A,
      static_cast<const T*>(B), static_cast<const T*>(C), Dv,
      static_cast<T*>(y), h_out, L, D, N, b_sb, b_sl, c_sb, c_sl);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_t(const void* u, const void* delta, const float* A, const void* B,
             const void* C, const float* Dv, void* y, float* h_out, int batch,
             int L, int D, int N, long long b_sb, long long b_sl,
             long long c_sb, long long c_sl, cudaStream_t s) {
  // 16-byte pieces need every row of u, delta, y, B and C to start on a
  // 16-byte boundary
  const long long es = sizeof(T);
  const bool vec = aligned16(u) && aligned16(delta) && aligned16(y) &&
                   aligned16(B) && aligned16(C) && (D * es) % 16 == 0 &&
                   (b_sb * es) % 16 == 0 && (b_sl * es) % 16 == 0 &&
                   (c_sb * es) % 16 == 0 && (c_sl * es) % 16 == 0;
  return vec ? launch<T, true>(u, delta, A, B, C, Dv, y, h_out, batch, L, D,
                               N, b_sb, b_sl, c_sb, c_sl, s)
             : launch<T, false>(u, delta, A, B, C, Dv, y, h_out, batch, L, D,
                                N, b_sb, b_sl, c_sb, c_sl, s);
}

template <typename T>
int blocks_per_sm() {
  const int bytes = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      scan_fwd<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_fwd<T, true>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, scan_fwd<T, true>,
                                                      kThreads, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// The chunk geometry: channels a block owns (one warp each), the steps a
// lane owns in a chunk, and the steps of a chunk (32 lanes' worth).
extern "C" void mamba_scan_tile(int* channels, int* items, int* chunk) {
  *channels = kCh;
  *items = kItems;
  *chunk = kT;
}

// Blocks of scan_fwd (16-byte pieces) that fit one SM of the current
// device at dtype 0 (float32) or 1 (bfloat16), from the CUDA occupancy
// calculator with the launch's shared memory; a CUDA error as a negative
// number.
extern "C" int mamba_scan_blocks_per_sm(int dtype) {
  return dtype == kDtypeBF16 ? blocks_per_sm<__nv_bfloat16>()
                             : blocks_per_sm<float>();
}

// u, delta: (batch, L, D) contiguous; A: (D, N) float32 contiguous; B, C:
// (batch, L, N) with unit stride over N and the given batch and time
// strides (in elements); Dv: (D,) float32; y: (batch, L, D) contiguous;
// h_out: (batch, D, N) float32 contiguous.  u, delta, B, C and y share one
// dtype, float32 (0) or bfloat16 (1).  Requires L >= 1 and 1 <= N <= 16
// (checked by the wrapper).
extern "C" int mamba_scan_launch(const void* u, const void* delta,
                                 const void* A, const void* B, const void* C,
                                 const void* Dv, void* y, void* h_out,
                                 int batch, int L, int D, int N,
                                 long long b_sb, long long b_sl,
                                 long long c_sb, long long c_sl, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || D == 0) return (int)cudaGetLastError();
  const float* a = static_cast<const float*>(A);
  const float* dv = static_cast<const float*>(Dv);
  float* h = static_cast<float*>(h_out);
  if (dtype == kDtypeBF16)
    return launch_t<__nv_bfloat16>(u, delta, a, B, C, dv, y, h, batch, L, D,
                                   N, b_sb, b_sl, c_sb, c_sl, s);
  return launch_t<float>(u, delta, a, B, C, dv, y, h, batch, L, D, N, b_sb,
                         b_sl, c_sb, c_sl, s);
}
