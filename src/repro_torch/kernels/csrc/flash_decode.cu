// One-token GQA decode attention with an online softmax.
//
// Replaces `flash_decode_pallas` (src/repro/kernels/flash_decode.py), behind
// `ops.flash_decode`.  q [B, H, D] f32 (pre-scaled by 1/sqrt(D)); k and v
// [B, S, KH, D] in f32, bf16 or f16, widened to f32 in registers (the TPU
// wrapper casts them first; the values are the same); kv_len i32[B].  Per
// (b, h), with kv head h / (H / KH) and positions s < kv_len[b]:
//
//   o = sum_s p_s v_s / max(sum_s p_s, 1e-20),  p_s = exp(q.k_s - max q.k)
//
// as the TPU wrapper normalises, so a row with kv_len 0 gives 0.
//
// Design: one block per (b, q head), NWARPS warps.  Warp w takes positions
// w, w + NWARPS, ... below min(kv_len, S); its 32 lanes split D (lane j
// holds elements j, j + 32, ...), so each K and V row is one coalesced
// warp load.  Per position: a partial dot per lane, a butterfly sum, and
// the online update m' = max(m, s), alpha = exp(m - m') (0 while m is
// still NEG_INF, the TPU kernel's guard), p = exp(s - m'), l = l*alpha + p,
// acc = acc*alpha + p*v.  The warps' (m, l, acc) are merged through shared
// memory at the end; a warp that saw no position (m still NEG_INF) weighs
// 0.  Positions at or past kv_len are never read.
//
// Bound on the card: bytes -- the K and V rows below kv_len, read once per
// kv head, plus q and o.  The H/KH q heads of a group read the same rows;
// h varies fastest in the grid, so their blocks run side by side and the
// repeats hit L2.  Splitting S across blocks (flash-decoding) to keep the
// card busy at small B*H is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)
#define MAX_D 256
#define EPL (MAX_D / 32)
#define NWARPS 8

struct DecodeArgs {
  const float* q;    // [B, H, D]
  const void* k;     // [B, S, KH, D]
  const void* v;     // [B, S, KH, D]
  const int* kv_len; // [B]
  float* o;          // [B, H, D]
  int B;
  int H;
  int KH;
  int S;
  int D;
  int dtype;         // 0 f32, 1 bf16, 2 f16
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_decode_kernel(const DecodeArgs a) {
  __shared__ float s_m[NWARPS];
  __shared__ float s_l[NWARPS];
  __shared__ float s_acc[NWARPS][MAX_D];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h / (a.H / a.KH);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int D = a.D;
  int len = a.kv_len[b];
  len = len < 0 ? 0 : (len > a.S ? a.S : len);
  const float* qr = a.q + (static_cast<size_t>(b) * a.H + h) * D;
  float q[EPL], acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int j = lane + 32 * i;
    q[i] = j < D ? qr[j] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;
  const size_t stride = static_cast<size_t>(a.KH) * D;  // between positions
  const size_t base = static_cast<size_t>(b) * a.S * stride +
                      static_cast<size_t>(kh) * D;
  const T* K = static_cast<const T*>(a.k) + base;
  const T* V = static_cast<const T*>(a.v) + base;
  for (int s = w; s < len; s += NWARPS) {
    const T* kr = K + s * stride;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int j = lane + 32 * i;
      if (j < D) part += q[i] * widen(kr[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    const float m_new = fmaxf(m, part);
    const float alpha = m == NEG_INF ? 0.f : expf(m - m_new);
    const float p = expf(part - m_new);
    l = l * alpha + p;
    const T* vr = V + s * stride;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int j = lane + 32 * i;
      if (j < D) acc[i] = acc[i] * alpha + p * widen(vr[j]);
    }
    m = m_new;
  }
  if (lane == 0) {
    s_m[w] = m;
    s_l[w] = l;
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int j = lane + 32 * i;
    if (j < D) s_acc[w][j] = acc[i];
  }
  __syncthreads();
  float mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) mx = fmaxf(mx, s_m[i]);
  float f[NWARPS];
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) {
    f[i] = s_m[i] == NEG_INF ? 0.f : expf(s_m[i] - mx);
    total += s_l[i] * f[i];
  }
  const float den = fmaxf(total, 1e-20f);
  float* orow = a.o + (static_cast<size_t>(b) * a.H + h) * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < NWARPS; ++i) o += s_acc[i][j] * f[i];
    orow[j] = o / den;
  }
}

template <typename T>
static int launch(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(a.H, a.B);
  flash_decode_kernel<T><<<grid, NWARPS * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_decode_launch(const DecodeArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0) return 0;
  if (a->KH <= 0 || a->H % a->KH != 0 || a->D <= 0 || a->D > MAX_D ||
      a->S < 0 || a->B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return launch<float>(*a, s);
    case 1: return launch<__nv_bfloat16>(*a, s);
    case 2: return launch<__half>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
