// Numerical-NF inference over a batch of keys: feats f32[B, dim] -> z f32[B].
//
// Replaces `nf_forward_pallas` (src/repro/kernels/nf_forward.py), the
// bulk-load transform of the flat backend.  One thread per key runs the
// shared routine of nf_device.cuh, so the z written here is bit-equal to
// the z that fused_lookup.cu computes in-kernel for the same key.
//
// Bound on the card: memory.  Per key it reads 4*dim bytes and writes 4
// (12 bytes at dim=2) for some 40 flops (two tanh), far below the 67
// TFLOP/s f32 rate, so the floor is 12 bytes/key over 3.35 TB/s.  The
// design does nothing clever about it yet: each thread loads its own
// feature row (neighbouring threads, neighbouring rows) and the weights
// come from shared memory, so device memory sees only the features and z.
#include <cstdint>

#include "nf_device.cuh"

template <int MAXW>
__global__ void nf_forward_kernel(const float* __restrict__ feats,
                                  float* __restrict__ out, int B,
                                  const NFParams p) {
  __shared__ float sw[NF_MAX_W];
  nf_stage_weights(p, sw);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float x[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    x[k] = (k < p.dim) ? __ldg(feats + (int64_t)i * p.dim + k) : 0.f;
  }
  out[i] = nf_eval<MAXW>(x, p, sw);
}

extern "C" int nf_forward_launch(const float* feats, float* out, int B,
                                 const NFParams* p, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = nf_max_width(*p);
  if (w <= 4) {
    nf_forward_kernel<4><<<blocks, threads, 0, s>>>(feats, out, B, *p);
  } else if (w <= 8) {
    nf_forward_kernel<8><<<blocks, threads, 0, s>>>(feats, out, B, *p);
  } else if (w <= 16) {
    nf_forward_kernel<16><<<blocks, threads, 0, s>>>(feats, out, B, *p);
  } else if (w <= 32) {
    nf_forward_kernel<32><<<blocks, threads, 0, s>>>(feats, out, B, *p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
