// Fused point lookup: optional NF forward, FlatAFLI traversal, exact 64-bit
// identity resolution and the delta > run write-tier probe, one thread per
// query.
//
// Replaces `fused_lookup_pallas` (src/repro/kernels/fused_lookup.py), the
// kernel behind every read of the flat backend.  Semantics follow the
// pure-jnp oracle `flat_lookup` (src/repro/core/flat_afli.py) plus the
// in-kernel tier probe, branch for branch:
//
//  * model node: slot = rint(slope*z + intercept) with the multiply and
//    the add rounded separately (__fmul_rn/__fadd_rn), exactly the numpy
//    builder's f32 arithmetic, so placement agrees by construction;
//    clipped to [0, size-1];
//  * dense node: `dense_iters` rounds of binary search over the node's
//    slice (the oracle's fixed-round loop, reads clamped to the pool),
//    then the FIRST entry of the `dense_window` scan whose f32 key and
//    identity both match;
//  * bucket: the MAX payload over identity matches with col < blen;
//  * tiers: delta, then run, each by `probe_tier` (tier_device.cuh, shared
//    with the range kernel): lower_bound plus the identity window
//    [l - W, l + 3W); the newest (highest) index wins, a tier match
//    (TOMBSTONE included) beats every older tier, TOMBSTONE maps to -1.
//
// Identity halves travel as int32 bit views of the u32 pools; only
// equality is ever taken.  The TPU kernel's batch-gated `lax.cond` has
// no counterpart: each thread early-exits its own traversal, and warps
// diverge where their queries do.
//
// Bound on the card: memory latency and sectors.  Every level is a chain
// of dependent random reads (node fields, then the entry, then a bucket
// row), each touching its own 32-byte sector, and a query's levels are
// serial.  The floor is the sectors a query must touch (counted per run
// by chip_smoke.py from the pool layout and the measured mean depth) over
// 3.35 TB/s.  The design keeps one query per thread so that many
// independent chains are in flight per SM, reads pools through the
// read-only path (__ldg), and keeps the NF in registers, so z never
// round-trips through device memory before the traversal uses it.
#include <cstdint>

#include "nf_device.cuh"
#include "tier_device.cuh"

#define KIND_MODEL 0
#define KIND_DENSE 1
#define ET_EMPTY 0
#define ET_DATA 1
#define ET_BUCKET 2
#define ET_CHILD 3
#define TOMBSTONE (-2)

struct LookupArgs {
  const float* feats;
  const int* qhi;
  const int* qlo;
  const int* nkind;
  const float* nslope;
  const float* nicept;
  const int* noff;
  const int* nsize;
  const int* etype;
  const float* ekey;
  const int* ehi;
  const int* elo;
  const int* epay;
  const int* echild;
  const int* bhi;
  const int* blo;
  const int* bpay;
  const int* blen;
  const float* rpk;
  const int* rhi;
  const int* rlo;
  const int* rpv;
  const int* rlen;
  const float* dpk;
  const int* dhi;
  const int* dlo;
  const int* dpv;
  const int* dlen;
  int* out_pay;
  float* out_z;
  int B;
  int feat_dim;
  int use_flow;
  int max_depth;
  int dense_iters;
  int bucket_cap;
  int dense_window;
  int n_entries;
  int probe_tiers;
  int run_cap;
  int run_iters;
  int run_window;
  int dl_cap;
  int dl_iters;
  int dl_window;
  int pad_;
};

template <int MAXW>
__global__ void fused_lookup_kernel(const LookupArgs a, const NFParams p) {
  __shared__ float sw[NF_MAX_W];
  if (a.use_flow) nf_stage_weights(p, sw);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;

  float q;
  if (a.use_flow) {
    float x[MAXW];
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      x[k] = (k < p.dim) ? __ldg(a.feats + (int64_t)i * a.feat_dim + k) : 0.f;
    }
    q = nf_eval<MAXW>(x, p, sw);
  } else {
    q = __ldg(a.feats + (int64_t)i * a.feat_dim);
  }
  const int qhi = __ldg(a.qhi + i);
  const int qlo = __ldg(a.qlo + i);

  int node = 0;
  int result = -1;
  for (int depth = 0; depth < a.max_depth; ++depth) {
    const int kind = __ldg(a.nkind + node);
    const int off = __ldg(a.noff + node);
    const int size = __ldg(a.nsize + node);
    if (kind == KIND_DENSE) {
      int l = off, h = off + size;
      for (int it = 0; it < a.dense_iters; ++it) {
        const int mid = (l + h) >> 1;
        const int m = mid < a.n_entries ? mid : a.n_entries - 1;
        if (__ldg(a.ekey + m) < q) {
          l = mid + 1;
        } else {
          h = mid;
        }
      }
      const int last = off + size - 1;
      int e = l < off ? off : (l > last ? last : l);
      result = -1;
      for (int w = 0; w < a.dense_window; ++w) {
        const int j = (e + w) > last ? last : (e + w);
        if (__ldg(a.ekey + j) == q && __ldg(a.ehi + j) == qhi &&
            __ldg(a.elo + j) == qlo) {
          result = __ldg(a.epay + j);
          break;
        }
      }
      break;
    }
    const float slope = __ldg(a.nslope + node);
    const float icpt = __ldg(a.nicept + node);
    int slot = __float2int_rz(rintf(__fadd_rn(__fmul_rn(slope, q), icpt)));
    slot = slot < 0 ? 0 : (slot > size - 1 ? size - 1 : slot);
    const int e = off + slot;
    const int et = __ldg(a.etype + e);
    if (et == ET_DATA) {
      result = (__ldg(a.ehi + e) == qhi && __ldg(a.elo + e) == qlo)
                   ? __ldg(a.epay + e) : -1;
      break;
    }
    if (et == ET_BUCKET) {
      int bid = __ldg(a.echild + e);
      bid = bid < 0 ? 0 : bid;
      const int len = __ldg(a.blen + bid);
      const int64_t row = (int64_t)bid * a.bucket_cap;
      int best = -1;
      for (int c = 0; c < a.bucket_cap; ++c) {
        if (c < len && __ldg(a.bhi + row + c) == qhi &&
            __ldg(a.blo + row + c) == qlo) {
          const int v = __ldg(a.bpay + row + c);
          best = v > best ? v : best;
        }
      }
      result = best;
      break;
    }
    if (et == ET_CHILD) {
      node = __ldg(a.echild + e);
      result = -1;
      continue;
    }
    result = -1;  // EMPTY
    break;
  }

  if (a.probe_tiers) {
    const int dl = probe_tier(a.dpk, a.dhi, a.dlo, a.dpv, __ldg(a.dlen),
                              a.dl_cap, a.dl_iters, a.dl_window, q, qhi,
                              qlo);
    const int rn = probe_tier(a.rpk, a.rhi, a.rlo, a.rpv, __ldg(a.rlen),
                              a.run_cap, a.run_iters, a.run_window, q, qhi,
                              qlo);
    result = dl != -1 ? dl : (rn != -1 ? rn : result);
    if (result == TOMBSTONE) result = -1;
  }
  a.out_pay[i] = result;
  a.out_z[i] = q;
}

extern "C" int fused_lookup_launch(const LookupArgs* a, const NFParams* p,
                                   void* stream) {
  if (a->B <= 0) return 0;
  const int threads = 256;
  const int blocks = (a->B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = a->use_flow ? nf_max_width(*p) : 1;
  if (w <= 4) {
    fused_lookup_kernel<4><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 8) {
    fused_lookup_kernel<8><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 16) {
    fused_lookup_kernel<16><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 32) {
    fused_lookup_kernel<32><<<blocks, threads, 0, s>>>(*a, *p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
