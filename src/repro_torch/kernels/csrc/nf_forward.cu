// Numerical-NF inference over a batch of keys: feats f32[B, dim] -> z f32[B].
//
// Replaces `nf_forward_pallas` (src/repro/kernels/nf_forward.py), the
// bulk-load transform of the flat backend and the positioning keys of
// every flow-on write batch.  Each key runs the shared routine of
// nf_device.cuh, so the z written here is bit-equal to the z that the
// lookup, streamed-lookup and range kernels compute in-kernel for the
// same key.
//
// Bound on the card: per key it reads 4*dim bytes and writes 4 (12 bytes
// at dim 2), and issues the routine's rounded multiplies and adds one
// FP32 slot each (they must not fuse) plus the accurate tanhf's
// instruction sequence, two of them SFU operations, per hidden unit.
// At 2^24 keys the bytes and the FP32 issue are close (chip_smoke.py's
// nf_forward_row computes both from the SASS), so the design keeps both
// lean:
//
//  * the default flow's routine is unrolled with its weights as operands
//    from the kernel-parameter bank: no shared memory, no barrier, no
//    guard or address arithmetic per product;
//  * with 16-byte aligned features, each thread takes four keys a step:
//    two 16-byte feature loads, one 16-byte store of z; the grid is the
//    card's resident blocks, each thread striding over the batch; the
//    batch's last B % 4 keys go one per thread;
//  * any other flow, or an unaligned feats view, takes one key per
//    thread with scalar loads (same routine, same bits).
#include <cstdint>

#include "nf_device.cuh"

#define THREADS 128

// Default flow, feats 16-byte aligned: four keys per thread per step.
__global__ void __launch_bounds__(THREADS)
    nf_forward_vec4(const float* __restrict__ feats, float* __restrict__ out,
                    int B, const __grid_constant__ NFParams p) {
  const int n4 = B >> 2;
  const float4* f4 = reinterpret_cast<const float4*>(feats);
  float4* o4 = reinterpret_cast<float4*>(out);
  const int stride = gridDim.x * THREADS;
  for (int g = blockIdx.x * THREADS + threadIdx.x; g < n4; g += stride) {
    const float4 a = __ldg(f4 + 2 * (int64_t)g);
    const float4 b = __ldg(f4 + 2 * (int64_t)g + 1);
    const float x0[2] = {a.x, a.y};
    const float x1[2] = {a.z, a.w};
    const float x2[2] = {b.x, b.y};
    const float x3[2] = {b.z, b.w};
    float4 z;
    z.x = nf_eval<NF_DEFAULT>(x0, p);
    z.y = nf_eval<NF_DEFAULT>(x1, p);
    z.z = nf_eval<NF_DEFAULT>(x2, p);
    z.w = nf_eval<NF_DEFAULT>(x3, p);
    o4[g] = z;
  }
  const int i = 4 * n4 + blockIdx.x * THREADS + threadIdx.x;
  if (i < B) out[i] = nf_eval_row<NF_DEFAULT>(feats, 2 * (int64_t)i, p);
}

// Any flow kind, any alignment: one key per thread per step.
template <int NF>
__global__ void __launch_bounds__(THREADS)
    nf_forward_scalar(const float* __restrict__ feats,
                      float* __restrict__ out, int B,
                      const __grid_constant__ NFParams p) {
  const int stride = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B; i += stride) {
    out[i] = nf_eval_row<NF>(feats, (int64_t)i * p.dim, p);
  }
}

// Blocks for `work` thread-steps: one a thread if the card's resident
// blocks (`full`) can hold them all, else `full`.
static int grid_for(int full, int work) {
  const int need = (work + THREADS - 1) / THREADS;
  return need < full ? (need > 0 ? need : 1) : full;
}

extern "C" int nf_forward_launch(const float* feats, float* out, int B,
                                 const NFParams* p, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kind = nf_kind(*p, true);
  if (kind == NF_DEFAULT && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    static const int full = resident_blocks(nf_forward_vec4, THREADS, 0);
    // the B % 4 tail keys go to the first threads of the grid
    const int work = (B >> 2) > (B & 3) ? (B >> 2) : (B & 3);
    nf_forward_vec4<<<grid_for(full, work), THREADS, 0, s>>>(feats, out, B,
                                                            *p);
    return static_cast<int>(cudaGetLastError());
  }
  return nf_dispatch(kind, [&](auto k) {
    constexpr int NF = decltype(k)::value;
    static const int full = resident_blocks(nf_forward_scalar<NF>, THREADS, 0);
    nf_forward_scalar<NF><<<grid_for(full, B), THREADS, 0, s>>>(feats, out,
                                                                B, *p);
    return static_cast<int>(cudaGetLastError());
  });
}
