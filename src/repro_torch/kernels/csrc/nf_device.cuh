// Numerical-NF forward for one key, shared by every kernel of the port.
//
// Replaces `apply_flow_tile` (src/repro/kernels/nf_forward.py), the flow
// arithmetic that both `nf_forward_pallas` and `fused_lookup_pallas`
// compile.  Build-time and serve-time positioning keys must be bit-equal,
// or a key built into one slot is probed in its neighbour and missed.
// The TPU kernels get there by evaluating the flow on fixed NF_TILE
// sub-tiles behind an optimization barrier; here the guarantee is by
// construction instead:
//
//  * every multiply and add is an explicit round-to-nearest intrinsic
//    (__fmul_rn / __fadd_rn / __fsub_rn).  nvcc contracts a*b+c into an
//    FMA by default and may contract the same inline source differently
//    in two kernels; the intrinsics are never contracted, so this routine
//    computes the same bits wherever it is inlined, and the same bits as
//    the plain PyTorch version (one rounding per elementwise op);
//  * tanh is the accurate `tanhf` (no --use_fast_math);
//  * one thread evaluates one key, so no tile shape enters the result.
//
// Weights arrive as a kernel argument (`NFParams`, the pack_flow_weights
// layout: mu | 1/sd | per layer [W row-major out x in | b] | out_scale)
// and are staged once per block into shared memory, from where every
// thread reads the same address (a broadcast).  The hidden state lives
// in registers: the loops unroll to MAXW, the widest layer rounded up to
// a power of two, and guard on the real widths.
#pragma once

#include <cuda_runtime.h>

#define NF_MAX_LAYERS 8
#define NF_MAX_W 768

struct NFParams {
  int dim;
  int n_layers;
  int n_out[NF_MAX_LAYERS];
  int n_in[NF_MAX_LAYERS];
  int n_w;
  float w[NF_MAX_W];
};

// Copy the packed weights of `p` into shared memory `sw`; every thread
// of the block calls it before the first nf_eval.
__device__ __forceinline__ void nf_stage_weights(const NFParams& p,
                                                 float* sw) {
  for (int i = threadIdx.x; i < p.n_w; i += blockDim.x) sw[i] = p.w[i];
  __syncthreads();
}

// z = sum_k h_k * out_scale_k of the flow applied to one key's expanded
// features x[0..dim).
template <int MAXW>
__device__ __forceinline__ float nf_eval(const float* x, const NFParams& p,
                                         const float* sw) {
  const int dim = p.dim;
  float h[MAXW];
  float t[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    h[k] = (k < dim) ? __fmul_rn(__fsub_rn(x[k], sw[k]), sw[dim + k]) : 0.f;
  }
  int idx = 2 * dim;
  for (int l = 0; l < p.n_layers; ++l) {
    const int no = p.n_out[l];
    const int ni = p.n_in[l];
    const bool last = (l == p.n_layers - 1);
#pragma unroll
    for (int j = 0; j < MAXW; ++j) {
      float acc = 0.f;
      if (j < no) {
        acc = sw[idx + no * ni + j];  // bias
#pragma unroll
        for (int k = 0; k < MAXW; ++k) {
          if (k < ni) acc = __fadd_rn(acc, __fmul_rn(h[k], sw[idx + j * ni + k]));
        }
        if (!last) acc = tanhf(acc);
      }
      t[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < MAXW; ++j) h[j] = t[j];
    idx += no * ni + no;
  }
  float z = __fmul_rn(h[0], sw[idx]);
#pragma unroll
  for (int k = 1; k < MAXW; ++k) {
    if (k < dim) z = __fadd_rn(z, __fmul_rn(h[k], sw[idx + k]));
  }
  return z;
}

// Smallest supported unroll width covering every layer of `p`.
static inline int nf_max_width(const NFParams& p) {
  int m = p.dim;
  for (int l = 0; l < p.n_layers; ++l) {
    if (p.n_out[l] > m) m = p.n_out[l];
    if (p.n_in[l] > m) m = p.n_in[l];
  }
  return m;
}
