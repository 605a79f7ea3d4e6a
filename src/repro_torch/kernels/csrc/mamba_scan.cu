// Mamba1 selective scan, one group of G lanes per (batch row, channel).
//
// Replaces `mamba_scan_pallas` (src/repro/kernels/mamba_scan.py), the fused
// selective scan that every prefill layer of an ssm model runs under
// SSMConfig.use_scan_kernel.  For batch row b and channel d, with h_0 = 0:
//
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n]
//
// A = -exp(a_log) comes from the wrapper, as the TPU kernel's wrapper
// computes it.  The final state is computed and dropped, as there.
//
// Design: time is serial; channels and state lanes are parallel.  A group
// of G = min(32, next_pow2(N)) lanes of one warp takes one channel; lane g
// keeps h[n] for n = g, g + G, ... (NPL states) in registers for the whole
// sequence, so the state history never leaves the SM.  Each step reads dt
// and x once per channel (the G lanes of a group read one address, a
// broadcast), B_t and C_t per lane (every channel reads the same N values,
// so they stay in L1/L2), computes expf(dt * A) once per (d, n), and sums
// h * C over the group with __shfl_xor_sync.  Every multiply and add is
// rounded alone (__fmul_rn/__fadd_rn) and expf is the accurate one (the
// build has no fast math), so h follows the plain version's torch
// arithmetic step for step; y_t differs from it only in the order of the
// N-term sum (lane sum, then a butterfly here; torch's reduction there).
//
// Bound on the card: the larger of its bytes (dt, x and y at 4 B per
// (b, t, d); B and C at 4 B per (b, t, n); A once) over device memory, and
// its B*L*di*N exponentials over the special-function units (16 results
// per SM per clock on sm_90).  At falcon-mamba-7b's width (di 8192, N 16)
// the two are within a few percent of each other.  Inputs are read
// straight from global memory through the read-only path; staging a time
// chunk of dt/x/B/C through shared memory (cp.async or TMA) is later work.
#include <cuda_runtime.h>

#define MAX_NPL 4

struct MambaArgs {
  const float* dt;     // [B, L, di]
  const float* xi;     // [B, L, di]
  const float* b_in;   // [B, L, N]
  const float* c_out;  // [B, L, N]
  const float* a_neg;  // [di, N]
  float* y;            // [B, L, di]
  int B;
  int L;
  int di;
  int N;
};

template <int G, int NPL>
__global__ void __launch_bounds__(256) mamba_scan_kernel(const MambaArgs a) {
  const int g = threadIdx.x % G;
  const int d0 = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  // a group past the last channel runs on a copy of the last one (so every
  // lane of the warp reaches the shuffles) and stores nothing
  const bool valid = d0 < a.di;
  const size_t d = valid ? d0 : a.di - 1;
  const size_t di = a.di;
  const int N = a.N;
  const size_t row = static_cast<size_t>(blockIdx.y) * a.L;
  float A[NPL], h[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int n = g + k * G;
    A[k] = n < N ? __ldg(a.a_neg + d * N + n) : 0.f;
    h[k] = 0.f;
  }
  const float* dt = a.dt + row * di + d;
  const float* xi = a.xi + row * di + d;
  const float* bm = a.b_in + row * N;
  const float* cm = a.c_out + row * N;
  float* y = a.y + row * di + d;
#pragma unroll 4
  for (int t = 0; t < a.L; ++t) {
    const float dtv = __ldg(dt + t * di);
    const float dx = __fmul_rn(dtv, __ldg(xi + t * di));
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int n = g + k * G;
      if (n < N) {
        const float abar = expf(__fmul_rn(dtv, A[k]));
        const float bx = __fmul_rn(dx, __ldg(bm + static_cast<size_t>(t) * N + n));
        h[k] = __fadd_rn(__fmul_rn(abar, h[k]), bx);
        acc = __fadd_rn(acc, __fmul_rn(h[k], __ldg(cm + static_cast<size_t>(t) * N + n)));
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off, G));
    }
    if (g == 0 && valid) y[t * di] = acc;
  }
}

template <int G, int NPL>
static int launch(const MambaArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const int per_block = threads / G;
  const dim3 grid((a.di + per_block - 1) / per_block, a.B);
  mamba_scan_kernel<G, NPL><<<grid, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mamba_scan_launch(const MambaArgs* a, void* stream) {
  if (a->B <= 0 || a->L <= 0 || a->di <= 0) return 0;
  if (a->N <= 0 || a->N > 32 * MAX_NPL || a->B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = a->N;
  if (n <= 1) return launch<1, 1>(*a, s);
  if (n <= 2) return launch<2, 1>(*a, s);
  if (n <= 4) return launch<4, 1>(*a, s);
  if (n <= 8) return launch<8, 1>(*a, s);
  if (n <= 16) return launch<16, 1>(*a, s);
  if (n <= 32) return launch<32, 1>(*a, s);
  if (n <= 64) return launch<32, 2>(*a, s);
  if (n <= 96) return launch<32, 3>(*a, s);
  return launch<32, 4>(*a, s);
}
