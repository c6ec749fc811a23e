// mamba_scan.cu — the Mamba-1 selective scan as one hand-written CUDA
// kernel for Hopper (sm_90a).
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
// Design.  The TPU kernel runs a grid over channel blocks with time
// sequential inside and the (block_d, N) state in VMEM.  Here channels are
// parallel too, and time is a loop inside the block:
//   * four threads share one (batch, channel): each holds NPT = ceil(N/4)
//     of its N <= 16 states in registers; y_t is their partial sums added
//     by two warp shuffles.  A block is 32 channels (128 threads), the
//     grid (ceil(D / 32), batch), so B = 1, D = 8192 gives 256 blocks,
//     about two per SM;
//   * per chunk of kT = 64 steps the block stages u and delta for its 32
//     channels (coalesced rows of 128 bytes in float32) and the chunk's B
//     and C rows in shared memory, walks the chunk, keeps y_t in shared
//     memory and writes the chunk's y as coalesced rows;
//   * the next chunk's loads are issued into registers before the walk
//     over this one, so their latency (hundreds of ns each) passes while
//     it runs instead of between chunks.  Each thread stages fixed
//     elements (16 of u and of delta, 8 of B and of C), all of a chunk's
//     loads independent;
//   * the walk is unrolled eight steps deep: a step's exp2f calls, loads
//     and y reduction (two shuffles) do not depend on the state, so only
//     one multiply-add a state is sequential per step;
//   * B and C are read through their own batch and time strides, so the
//     model's column slices of the x_proj output need no copy; their
//     last dimension must be contiguous;
//   * exp(delta*A) is exp2f(delta * A*log2(e)), with A scaled once per
//     thread.  exp2f is one MUFU instruction with at most 2 ulp of error;
//     the product with the pre-scaled A adds half an ulp of its argument.
//   * any L >= 1 (a partial last chunk), any D (a partial last block); the
//     states past N are zero (their B and C read as 0) and stay zero.
//
// What bounds it on an H100.  Each input is read once and y written once:
// at the main shape (batch 1, L = 8192, D = 8192, N = 16, float32) that is
// 0.81 GB, 0.24 ms at 3.35 TB/s.  It also makes L*D*N = 1.07e9 exp2f calls
// on the SMs' special-function units (16 a cycle per SM): about 0.26 ms at
// 1.98 GHz.  The recurrence is sequential in L, so at batch 1 only D/32
// blocks exist; a chunked parallel scan over L that fills all SMs is later
// work.  wgmma and TMA do not apply: there is no matrix product.
//
// Interface: plain C, loaded with ctypes.  The kernel launches on the
// caller's stream, does not synchronise and allocates nothing; the entry
// point returns cudaGetLastError() so a refused launch surfaces at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;                 // threads per (batch, channel)
constexpr int kCh = 32;                   // channels per block
constexpr int kThreads = kCh * kGroup;    // 128
constexpr int kT = 64;                    // time steps per staged chunk
constexpr int kMaxN = 16;
constexpr int kDtypeBF16 = 1;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements of a chunk each thread stages: u and delta, B and C.
constexpr int kPerUD = kT * kCh / kThreads;      // 16
constexpr int kPerBC = kT * kMaxN / kThreads;    // 8

template <typename T, int NPT>
__global__ void __launch_bounds__(kThreads)
scan_fwd(const T* __restrict__ u, const T* __restrict__ delta,
         const float* __restrict__ A, const T* __restrict__ Bm,
         const T* __restrict__ Cm, const float* __restrict__ Dv,
         T* __restrict__ y, float* __restrict__ h_out, int L, int D, int N,
         long long b_sb, long long b_sl, long long c_sb, long long c_sl) {
  __shared__ float u_s[kT][kCh];
  __shared__ float d_s[kT][kCh];
  __shared__ float y_s[kT][kCh];
  __shared__ float b_s[kT][kMaxN];
  __shared__ float c_s[kT][kMaxN];

  const int tid = threadIdx.x;
  const int cl = tid / kGroup;             // channel within the block
  const int g = tid % kGroup;              // which NPT states of it
  const int c0 = blockIdx.x * kCh;
  const int c = c0 + cl;
  const int batch = blockIdx.y;
  const bool live = c < D;

  float a2[NPT], h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = g * NPT + j;
    a2[j] = (live && n < N) ? A[(long long)c * N + n] * kLog2e : 0.f;
    h[j] = 0.f;
  }
  const float dskip = live ? Dv[c] : 0.f;

  const long long row0 = (long long)batch * L;  // first (batch, t) row of u
  const T* bb = Bm + batch * b_sb;
  const T* cb = Cm + batch * c_sb;

  // this thread's staged elements: u, delta and y at step (tid / kCh) +
  // i * (kThreads / kCh) of a chunk, channel c0 + tid % kCh; B and C at
  // step (tid / kMaxN) + i * (kThreads / kMaxN), state tid % kMaxN
  const int ud_t = tid / kCh, ud_c = tid % kCh;
  const int bc_t = tid / kMaxN, bc_n = tid % kMaxN;
  const bool ud_live = c0 + ud_c < D;
  const bool bc_live = bc_n < N;
  float pu[kPerUD], pd[kPerUD], pb[kPerBC], pc[kPerBC];

  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kPerUD; ++i) {
      const int t = t0 + ud_t + i * (kThreads / kCh);
      const bool ok = ud_live && t < L;
      const long long at = (row0 + t) * D + c0 + ud_c;
      pu[i] = ok ? to_f(u[at]) : 0.f;
      pd[i] = ok ? to_f(delta[at]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerBC; ++i) {
      const int t = t0 + bc_t + i * (kThreads / kMaxN);
      const bool ok = bc_live && t < L;
      pb[i] = ok ? to_f(bb[(long long)t * b_sl + bc_n]) : 0.f;
      pc[i] = ok ? to_f(cb[(long long)t * c_sl + bc_n]) : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < L; t0 += kT) {
    const int tn = min(kT, L - t0);
#pragma unroll
    for (int i = 0; i < kPerUD; ++i) {
      u_s[ud_t + i * (kThreads / kCh)][ud_c] = pu[i];
      d_s[ud_t + i * (kThreads / kCh)][ud_c] = pd[i];
    }
#pragma unroll
    for (int i = 0; i < kPerBC; ++i) {
      b_s[bc_t + i * (kThreads / kMaxN)][bc_n] = pb[i];
      c_s[bc_t + i * (kThreads / kMaxN)][bc_n] = pc[i];
    }
    __syncthreads();
    if (t0 + kT < L) fetch(t0 + kT);   // in flight during the walk

#pragma unroll 8
    for (int t = 0; t < tn; ++t) {
      const float ut = u_s[t][cl];
      const float dt = d_s[t][cl];
      const float dtu = dt * ut;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = g * NPT + j;
        const float da = exp2f(dt * a2[j]);
        h[j] = fmaf(da, h[j], dtu * b_s[t][n]);
        acc = fmaf(h[j], c_s[t][n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) y_s[t][cl] = fmaf(dskip, ut, acc);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPerUD; ++i) {
      const int t = ud_t + i * (kThreads / kCh);
      if (ud_live && t < tn)
        from_f(y + (row0 + t0 + t) * D + c0 + ud_c, y_s[t][ud_c]);
    }
    // the next chunk's staging writes u_s, d_s, b_s and c_s only; y_s is
    // written again after the next __syncthreads, when every thread has
    // stored this chunk's
  }

  if (live) {
    float* dst = h_out + ((long long)batch * D + c) * N;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = g * NPT + j;
      if (n < N) dst[n] = h[j];
    }
  }
}

template <typename T, int NPT>
void launch(const void* u, const void* delta, const float* A, const void* B,
            const void* C, const float* Dv, void* y, float* h_out, int batch,
            int L, int D, int N, long long b_sb, long long b_sl,
            long long c_sb, long long c_sl, cudaStream_t s) {
  dim3 grid((D + kCh - 1) / kCh, batch);
  scan_fwd<T, NPT><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), A,
      static_cast<const T*>(B), static_cast<const T*>(C), Dv,
      static_cast<T*>(y), h_out, L, D, N, b_sb, b_sl, c_sb, c_sl);
}

template <typename T>
void launch_n(const void* u, const void* delta, const float* A, const void* B,
              const void* C, const float* Dv, void* y, float* h_out,
              int batch, int L, int D, int N, long long b_sb, long long b_sl,
              long long c_sb, long long c_sl, cudaStream_t s) {
  switch ((N + kGroup - 1) / kGroup) {
    case 1: launch<T, 1>(u, delta, A, B, C, Dv, y, h_out, batch, L, D, N, b_sb, b_sl, c_sb, c_sl, s); break;
    case 2: launch<T, 2>(u, delta, A, B, C, Dv, y, h_out, batch, L, D, N, b_sb, b_sl, c_sb, c_sl, s); break;
    case 3: launch<T, 3>(u, delta, A, B, C, Dv, y, h_out, batch, L, D, N, b_sb, b_sl, c_sb, c_sl, s); break;
    default: launch<T, 4>(u, delta, A, B, C, Dv, y, h_out, batch, L, D, N, b_sb, b_sl, c_sb, c_sl, s); break;
  }
}

}  // namespace

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
    launch_n<__nv_bfloat16>(u, delta, a, B, C, dv, y, h, batch, L, D, N, b_sb, b_sl, c_sb, c_sl, s);
  else
    launch_n<float>(u, delta, a, B, C, dv, y, h, batch, L, D, N, b_sb, b_sl, c_sb, c_sl, s);
  return (int)cudaGetLastError();
}
