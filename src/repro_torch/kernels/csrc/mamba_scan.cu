// Mamba1 selective scan, fed from shared memory a time chunk at a time.
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
// Bound on the card: the larger of its bytes (dt, x and y at 4 B per
// (b, t, d); B and C at 4 B per (b, t, n); A once) over device memory, and
// its B*L*di*N exponentials over the special-function units (16 results
// per SM per clock on sm_90).  At falcon-mamba-7b's width (di 8192, N 16)
// the two are within a few percent of each other.  Time is serial, so
// what keeps a scan from either bound is the latency of each step's loads
// and the instructions each step issues.
//
// Design: a block takes CT = 32 channels of one batch row (a row of dt, x
// or y in a chunk is 128 contiguous bytes) with G lanes per channel; lane
// g keeps h[n] for n = g * NPL, ..., g * NPL + NPL - 1 in registers for
// the whole sequence.  Time runs in chunks of T steps: the chunk's dt and
// x (T x CT) and B and C (T x N, shared by the block's channels) are
// copied into shared memory with cp.async, double-buffered, so chunk c + 1
// loads while chunk c runs and the serial loop reads only shared memory
// and registers (B and C as one vector load per lane).  Each lane writes
// its states' share of y_t to shared memory, with no shuffle in the loop;
// at the chunk's end the G shares of each (t, channel) are summed and y is
// stored a 128-byte row at a time.  Every multiply and add is rounded
// alone (__fmul_rn/__fadd_rn) and expf is the accurate one (the build has
// no fast math), so h follows the plain version's torch arithmetic step
// for step; y_t differs from it only in the order of the N-term sum (each
// lane's states in turn, then the lanes in order; torch's reduction
// there).  The wrapper's plan picks G, NPL and T.
#include <cuda_runtime.h>
#include <stdint.h>

#define CT 32   // channels per block

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
  int lanes;           // G: lanes per channel
  int npl;             // states per lane (lanes * npl >= N)
  int chunk;           // T: time steps per staged chunk, a multiple of 4
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows x cols floats from global (row stride gs) into shared memory (row
// stride CT), 16 B at a time where every row start is 16 B aligned
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t gs, int rows, int cols) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (aligned16(src) && gs % 4 == 0 && cols % 4 == 0) {
    const int q = cols / 4;
    for (int i = tid; i < rows * q; i += nt) {
      const int r = i / q, c = (i - r * q) * 4;
      cp16(dst + r * CT + c, src + r * gs + c);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nt) {
      const int r = i / cols, c = i - r * cols;
      cp4(dst + r * CT + c, src + r * gs + c);
    }
  }
}

// n contiguous floats
__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int q = aligned16(src) ? n / 4 : 0;
  for (int i = tid; i < q; i += nt) cp16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * q + tid; i < n; i += nt) cp4(dst + i, src + i);
}

// NPL consecutive floats of shared memory (16 or 8 B aligned when FULL),
// of which the first `live` are states
template <int NPL, bool FULL>
__device__ __forceinline__ void load_states(const float* p, int live,
                                            float* out) {
  if (FULL && NPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if (FULL && NPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < NPL; ++k) out[k] = k < live ? p[k] : 0.f;
  }
}

template <int G, int NPL, bool FULL>
__global__ void __launch_bounds__(CT * G) mamba_scan_kernel(const MambaArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int T = a.chunk;
  const int N = a.N;
  const size_t di = a.di;
  const int stage = 2 * T * CT + 2 * T * N;   // floats per stage
  float* part = sm + 2 * stage;               // [T][CT][G] lane sums of y
  const int g = threadIdx.x % G;
  const int c = threadIdx.x / G;
  const int d0 = blockIdx.x * CT;
  const int ncol = min(CT, a.di - d0);
  // a group past the last channel runs on a copy of the last one and its
  // y is never stored
  const size_t d = c < ncol ? d0 + c : a.di - 1;
  const size_t row = static_cast<size_t>(blockIdx.y) * a.L;
  const int n0 = g * NPL;  // lane g keeps states n0 .. n0 + NPL - 1
  float A[NPL], h[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    A[k] = (FULL || n0 + k < N) ? __ldg(a.a_neg + d * N + n0 + k) : 0.f;
    h[k] = 0.f;
  }
  const int nchunks = (a.L + T - 1) / T;
  auto issue = [&](int ch) {
    const int t0 = ch * T;
    const int nt = min(T, a.L - t0);
    float* s = sm + (ch & 1) * stage;
    const size_t r0 = (row + t0) * di + d0;
    stage_rows(s, a.dt + r0, di, nt, ncol);
    stage_rows(s + T * CT, a.xi + r0, di, nt, ncol);
    stage_span(s + 2 * T * CT, a.b_in + (row + t0) * N, nt * N);
    stage_span(s + 2 * T * CT + T * N, a.c_out + (row + t0) * N, nt * N);
  };
  issue(0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) issue(ch + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();  // chunk ch landed for every thread; part is free
    const float* s = sm + (ch & 1) * stage;
    const float* sdt = s + c;
    const float* sx = s + T * CT + c;
    const float* sb = s + 2 * T * CT + n0;
    const float* sc = sb + T * N;
    float* pt = part + threadIdx.x;
    const int nt = min(T, a.L - ch * T);
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float dtv = sdt[t * CT];
      const float dx = __fmul_rn(dtv, sx[t * CT]);
      float bv[NPL], cv[NPL];
      load_states<NPL, FULL>(sb + t * N, N - n0, bv);
      load_states<NPL, FULL>(sc + t * N, N - n0, cv);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        if (FULL || n0 + k < N) {
          const float abar = expf(__fmul_rn(dtv, A[k]));
          h[k] = __fadd_rn(__fmul_rn(abar, h[k]), __fmul_rn(dx, bv[k]));
          acc = __fadd_rn(acc, __fmul_rn(h[k], cv[k]));
        }
      }
      pt[t * CT * G] = acc;
    }
    __syncthreads();  // part complete; stage ch & 1 free for chunk ch + 2
    // y_t = the G lane sums in lane order, stored a row of CT at a time
    float* y = a.y + (row + static_cast<size_t>(ch) * T) * di + d0;
    for (int i = threadIdx.x; i < nt * CT; i += blockDim.x) {
      const int t = i / CT, cc = i - t * CT;
      if (cc < ncol) {
        const float* q = part + i * G;
        float v = q[0];
#pragma unroll
        for (int j = 1; j < G; ++j) v = __fadd_rn(v, q[j]);
        y[t * di + cc] = v;
      }
    }
  }
}

template <int G, int NPL>
static int launch(const MambaArgs& a, cudaStream_t stream) {
  const int bytes = 4 * (2 * (2 * a.chunk * CT + 2 * a.chunk * a.N) +
                         a.chunk * CT * G);
  const bool full = G * NPL == a.N;
  static int raised[2] = {0, 0};
  if (bytes > 48 * 1024 && raised[full] < bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        full ? mamba_scan_kernel<G, NPL, true> : mamba_scan_kernel<G, NPL, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[full] = bytes;
  }
  const dim3 grid((a.di + CT - 1) / CT, a.B);
  if (full) {
    mamba_scan_kernel<G, NPL, true><<<grid, CT * G, bytes, stream>>>(a);
  } else {
    mamba_scan_kernel<G, NPL, false><<<grid, CT * G, bytes, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mamba_scan_launch(const MambaArgs* a, void* stream) {
  if (a->B <= 0 || a->L <= 0 || a->di <= 0) return 0;
  if (a->N <= 0 || a->lanes * a->npl < a->N || a->B > 65535 ||
      a->chunk <= 0 || a->chunk % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = a->lanes * 1000 + a->npl;
  switch (key) {
    case 1001: return launch<1, 1>(*a, s);
    case 2001: return launch<2, 1>(*a, s);
    case 4001: return launch<4, 1>(*a, s);
    case 8001: return launch<8, 1>(*a, s);
    case 8002: return launch<8, 2>(*a, s);
    case 8004: return launch<8, 4>(*a, s);
    case 8008: return launch<8, 8>(*a, s);
    case 8016: return launch<8, 16>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
