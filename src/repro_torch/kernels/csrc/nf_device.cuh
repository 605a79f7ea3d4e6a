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
// layout: mu | 1/sd | per layer [W row-major out x in | b] | out_scale).
// Every thread reads the same word of it, so a weight is an operand
// straight from the kernel-parameter bank: nothing is staged and no
// barrier waits for it.
//
// Like the Pallas kernel, which is compiled for its flow's shapes, the
// routine is specialised to the flow's shape at compile time.  A kernel
// that evaluates the NF takes a kind `NF` as a template argument:
//
//  * NF_DEFAULT: the default flow (dim 2, hidden 2, 2 layers: shapes
//    (4, 2), (2, 4)), every loop unrolled, every weight at a fixed
//    offset, no product guarded;
//  * 4, 8, 16 or 32: any other flow whose layers are at most that wide,
//    its shape read from the argument at run time and the products
//    guarded by the real widths.  No configuration of the repository
//    uses one; it keeps every other shape on the same hand-written code
//    without a build per shape.
//
// The host picks the kind with `nf_kind` and instantiates it with
// `nf_dispatch`.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#define NF_MAX_LAYERS 8
#define NF_MAX_W 768
#define NF_DEFAULT 0

struct NFParams {
  int dim;
  int n_layers;
  int n_out[NF_MAX_LAYERS];
  int n_in[NF_MAX_LAYERS];
  int n_w;
  float w[NF_MAX_W];
};

// Features a kernel of kind NF reads per key.
template <int NF>
__host__ __device__ constexpr int nf_width() {
  return NF == NF_DEFAULT ? 2 : NF;
}

// The default flow: dim D = 2, layers (D*H, D) and (D, D*H) with H = 2.
// The offsets are constants once the loops unroll.
__device__ __forceinline__ float nf_eval_default(const float* x,
                                                 const NFParams& p) {
  constexpr int D = 2;
  constexpr int W = 4;
  float h[W];
  float t[W];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    h[k] = __fmul_rn(__fsub_rn(x[k], p.w[k]), p.w[D + k]);
  }
  constexpr int L0 = 2 * D;           // layer 0: W x D, then W biases
  constexpr int L1 = L0 + W * D + W;  // layer 1: D x W, then D biases
  constexpr int OUT = L1 + D * W + D;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    float acc = p.w[L0 + W * D + j];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(h[k], p.w[L0 + j * D + k]));
    }
    t[j] = tanhf(acc);
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float acc = p.w[L1 + D * W + j];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(t[k], p.w[L1 + j * W + k]));
    }
    h[j] = acc;
  }
  float z = __fmul_rn(h[0], p.w[OUT]);
#pragma unroll
  for (int k = 1; k < D; ++k) z = __fadd_rn(z, __fmul_rn(h[k], p.w[OUT + k]));
  return z;
}

// Any flow up to MAXW wide, its shape read from `p` at run time.
template <int MAXW>
__device__ __forceinline__ float nf_eval_runtime(const float* x,
                                                 const NFParams& p) {
  const int dim = p.dim;
  float h[MAXW];
  float t[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    h[k] = (k < dim) ? __fmul_rn(__fsub_rn(x[k], p.w[k]), p.w[dim + k]) : 0.f;
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
        acc = p.w[idx + no * ni + j];  // bias
#pragma unroll
        for (int k = 0; k < MAXW; ++k) {
          if (k < ni) acc = __fadd_rn(acc, __fmul_rn(h[k], p.w[idx + j * ni + k]));
        }
        if (!last) acc = tanhf(acc);
      }
      t[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < MAXW; ++j) h[j] = t[j];
    idx += no * ni + no;
  }
  float z = __fmul_rn(h[0], p.w[idx]);
#pragma unroll
  for (int k = 1; k < MAXW; ++k) {
    if (k < dim) z = __fadd_rn(z, __fmul_rn(h[k], p.w[idx + k]));
  }
  return z;
}

// z = sum_k h_k * out_scale_k of the flow applied to one key's expanded
// features x[0..dim).
template <int NF>
__device__ __forceinline__ float nf_eval(const float* x, const NFParams& p) {
  if constexpr (NF == NF_DEFAULT) {
    return nf_eval_default(x, p);
  } else {
    return nf_eval_runtime<NF>(x, p);
  }
}

// z of the key whose features start at feats[off] (its row of
// f32[B, feat_dim]).
template <int NF>
__device__ __forceinline__ float nf_eval_row(const float* feats, int64_t off,
                                             const NFParams& p) {
  constexpr int W = nf_width<NF>();
  float x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    x[k] = (NF == NF_DEFAULT || k < p.dim) ? __ldg(feats + off + k) : 0.f;
  }
  return nf_eval<NF>(x, p);
}

// Smallest runtime-shape width covering every layer of `p`.
static inline int nf_max_width(const NFParams& p) {
  int m = p.dim;
  for (int l = 0; l < p.n_layers; ++l) {
    if (p.n_out[l] > m) m = p.n_out[l];
    if (p.n_in[l] > m) m = p.n_in[l];
  }
  return m;
}

// The kind a launch instantiates for flow `p` (NF_DEFAULT without the
// flow); -1: wider than 32.
static inline int nf_kind(const NFParams& p, bool use_flow) {
  if (!use_flow) return NF_DEFAULT;
  if (p.dim == 2 && p.n_layers == 2 && p.n_out[0] == 4 && p.n_in[0] == 2 &&
      p.n_out[1] == 2 && p.n_in[1] == 4) {
    return NF_DEFAULT;
  }
  const int m = nf_max_width(p);
  return m <= 4 ? 4 : m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : -1;
}

// f(std::integral_constant<int, NF>{}) for `kind`; a kind of -1 returns
// cudaErrorInvalidValue.
template <class F>
static int nf_dispatch(int kind, F&& f) {
  switch (kind) {
    case NF_DEFAULT:
      return f(std::integral_constant<int, NF_DEFAULT>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of `kernel` the whole card holds at once (its SMs times the
// blocks of `threads` threads and `smem` bytes of dynamic shared memory
// one SM holds); at least 1.
template <class K>
static int resident_blocks(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int n = sms * per_sm;
  return n > 0 ? n : 1;
}
