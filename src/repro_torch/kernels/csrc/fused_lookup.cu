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
//  * tiers: delta, then run, each matched in the identity window
//    [l - W, l + 3W) around q's lower bound l (`lower_bound`'s rounds,
//    then `window_pv`, tier_device.cuh); the newest (highest) index
//    wins, a tier match (TOMBSTONE included) beats every older tier,
//    TOMBSTONE maps to -1.
//
// Identity halves travel as int32 bit views of the u32 pools; only
// equality is ever taken.  The TPU kernel's batch-gated `lax.cond` has
// no counterpart: each thread early-exits its own traversal.
//
// Bound on the card: memory latency, then the bytes of the sectors it
// touches.  A query is a chain of dependent random reads; a warp lasts as
// long as its longest lane, and with tens of chains in flight per SM,
// every sector a round reads and does not need costs device-memory
// bandwidth.  The design:
//
//  * a tree level is two rounds: the node's five fields, then the
//    entry's type and child (in bounds at the same index, whatever the
//    type); a DATA entry's identity and payload are one more round, read
//    only for DATA entries.  A conflict bucket is two more: blen with the
//    row's hi columns (unrolled to BCAP and masked by blen; a wider
//    bucket takes the generic instantiation), then lo and payload only
//    of the columns whose hi matched.  The dense window is two as well:
//    its keys, then identity and payload only where the key matched;
//  * with tiers, half the block's warps walk the tree for 128 queries
//    while the other half probes the delta and the run for the same
//    queries (z handed over in shared memory).  The probe's two binary
//    searches step together, and its identity windows read hi four rows
//    a load, then lo and pv only where hi matched (`window_pv`).  A read
//    waits on the longer of the walk and the probe, not on their sum: in
//    one warp the lanes would wait for each other's chains;
//  * one query per thread otherwise, so many independent chains are in
//    flight per SM; pools through the read-only path (__ldg); the NF in
//    registers, evaluated once per query, its weights operands from the
//    kernel-parameter bank (nf_device.cuh).
//
// The floor is the sectors a batch must touch (counted per run by
// chip_smoke.py from the pool layout and the measured mean depth) over
// 3.35 TB/s.
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
#define THREADS 256
#define HALF (THREADS / 2)
#define BUCKET_UNROLL 8

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

// The tree's payload for one query (-1: miss).
template <int BCAP>
__device__ __forceinline__ int walk(const LookupArgs& a, float q, int qhi,
                                    int qlo) {
  int node = 0;
  for (int depth = 0; depth < a.max_depth; ++depth) {
    const int kind = __ldg(a.nkind + node);
    const int off = __ldg(a.noff + node);
    const int size = __ldg(a.nsize + node);
    const float slope = __ldg(a.nslope + node);
    const float icpt = __ldg(a.nicept + node);
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
      const int e = l < off ? off : (l > last ? last : l);
      // the window: keys first, then identity and payload where the key
      // matched; the first full match wins
      unsigned km = 0;
#pragma unroll 8
      for (int w = 0; w < a.dense_window && w < 32; ++w) {
        const int j = (e + w) > last ? last : (e + w);
        km |= (unsigned)(__ldg(a.ekey + j) == q) << w;
      }
      while (km) {
        const int w = __ffs(km) - 1;
        const int j = (e + w) > last ? last : (e + w);
        const int h2 = __ldg(a.ehi + j);
        const int o2 = __ldg(a.elo + j);
        const int v2 = __ldg(a.epay + j);
        if (h2 == qhi && o2 == qlo) return v2;
        km &= km - 1;
      }
      for (int w = 32; w < a.dense_window; ++w) {
        const int j = (e + w) > last ? last : (e + w);
        if (__ldg(a.ekey + j) == q && __ldg(a.ehi + j) == qhi &&
            __ldg(a.elo + j) == qlo) {
          return __ldg(a.epay + j);
        }
      }
      return -1;
    }
    int slot = __float2int_rz(rintf(__fadd_rn(__fmul_rn(slope, q), icpt)));
    slot = slot < 0 ? 0 : (slot > size - 1 ? size - 1 : slot);
    const int e = off + slot;
    const int et = __ldg(a.etype + e);
    const int ec = __ldg(a.echild + e);
    if (et == ET_DATA) {
      const int eh = __ldg(a.ehi + e);
      const int el = __ldg(a.elo + e);
      const int ep = __ldg(a.epay + e);
      return (eh == qhi && el == qlo) ? ep : -1;
    }
    if (et == ET_BUCKET) {
      const int bid = ec < 0 ? 0 : ec;
      const int64_t row = (int64_t)bid * a.bucket_cap;
      int best = -1;
      if constexpr (BCAP > 0) {
        // blen and the row's hi columns, then lo and payload where hi
        // matched
        const int len = __ldg(a.blen + bid);
        unsigned hm = 0;
#pragma unroll
        for (int c = 0; c < BCAP; ++c) {
          if (c < a.bucket_cap) {
            hm |= (unsigned)(__ldg(a.bhi + row + c) == qhi) << c;
          }
        }
        hm &= len >= BCAP ? ~0u : (len > 0 ? (1u << len) - 1u : 0u);
        while (hm) {
          const int c = __ffs(hm) - 1;
          const int o = __ldg(a.blo + row + c);
          const int v = __ldg(a.bpay + row + c);
          if (o == qlo) best = v > best ? v : best;
          hm &= hm - 1;
        }
      } else {
        const int len = __ldg(a.blen + bid);
        for (int c = 0; c < a.bucket_cap; ++c) {
          if (c < len && __ldg(a.bhi + row + c) == qhi &&
              __ldg(a.blo + row + c) == qlo) {
            const int v = __ldg(a.bpay + row + c);
            best = v > best ? v : best;
          }
        }
      }
      return best;
    }
    if (et != ET_CHILD) return -1;  // EMPTY
    node = ec;
  }
  return -1;
}

// The newest tier copy of (qhi, qlo): the delta's, else the run's, else
// -1 (a TOMBSTONE passes through).  Both lower bounds step together, one
// round each, so the two searches cost the longer one; then both
// identity windows (`window_pv`).
__device__ __forceinline__ int tier_probe(const LookupArgs& a, float q,
                                          int qhi, int qlo) {
  const int rn = __ldg(a.rlen);
  const int dn = __ldg(a.dlen);
  int rl = 0, rh = rn, dl = 0, dh = dn;
  const int iters = a.run_iters > a.dl_iters ? a.run_iters : a.dl_iters;
  for (int it = 0; it < iters; ++it) {
    const int rm = (rl + rh) >> 1;
    const int dm = (dl + dh) >> 1;
    const bool r_on = it < a.run_iters, d_on = it < a.dl_iters;
    const float rp =
        r_on ? __ldg(a.rpk + (rm < a.run_cap ? rm : a.run_cap - 1)) : 0.f;
    const float dp =
        d_on ? __ldg(a.dpk + (dm < a.dl_cap ? dm : a.dl_cap - 1)) : 0.f;
    if (r_on) {
      if (rp < q) {
        rl = rm + 1;
      } else {
        rh = rm;
      }
    }
    if (d_on) {
      if (dp < q) {
        dl = dm + 1;
      } else {
        dh = dm;
      }
    }
  }
  const int dv = window_pv(a.dhi, a.dlo, a.dpv, dn, a.dl_window, dl, qhi,
                           qlo);
  const int rv = window_pv(a.rhi, a.rlo, a.rpv, rn, a.run_window, rl, qhi,
                           qlo);
  return dv != -1 ? dv : rv;
}

template <int NF, int BCAP>
__global__ void __launch_bounds__(THREADS)
    fused_lookup_kernel(const LookupArgs a,
                        const __grid_constant__ NFParams p) {
  __shared__ float s_q[HALF];
  __shared__ int s_hi[HALF], s_lo[HALF], s_tier[HALF];
  // with tiers: the first half of the block walks HALF queries, the
  // second half probes the tiers for the same queries
  const bool tiers = a.probe_tiers != 0;
  const bool prober = tiers && threadIdx.x >= HALF;
  const int t = prober ? threadIdx.x - HALF : threadIdx.x;
  const int i = blockIdx.x * (tiers ? HALF : THREADS) + t;
  const bool live = i < a.B;

  float q = 0.f;
  int qhi = 0, qlo = 0;
  if (live && !prober) {
    if (a.use_flow) {
      q = nf_eval_row<NF>(a.feats, (int64_t)i * a.feat_dim, p);
    } else {
      q = __ldg(a.feats + (int64_t)i * a.feat_dim);
    }
    qhi = __ldg(a.qhi + i);
    qlo = __ldg(a.qlo + i);
  }
  if (tiers) {
    if (!prober) {
      s_q[t] = q;
      s_hi[t] = qhi;
      s_lo[t] = qlo;
    }
    __syncthreads();
    if (prober) {
      if (live) s_tier[t] = tier_probe(a, s_q[t], s_hi[t], s_lo[t]);
    }
  }
  int result = -1;
  if (live && !prober) result = walk<BCAP>(a, q, qhi, qlo);
  if (tiers) {
    __syncthreads();
    if (live && !prober) {
      const int tv = s_tier[t];
      result = tv != -1 ? tv : result;
      if (result == TOMBSTONE) result = -1;
    }
  }
  if (live && !prober) {
    a.out_pay[i] = result;
    a.out_z[i] = q;
  }
}

template <int BCAP>
static int launch_kind(const LookupArgs* a, const NFParams* p, int blocks,
                       cudaStream_t s) {
  return nf_dispatch(nf_kind(*p, a->use_flow != 0), [&](auto k) {
    constexpr int NF = decltype(k)::value;
    fused_lookup_kernel<NF, BCAP><<<blocks, THREADS, 0, s>>>(*a, *p);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int fused_lookup_launch(const LookupArgs* a, const NFParams* p,
                                   void* stream) {
  if (a->B <= 0) return 0;
  const int per_block = a->probe_tiers ? HALF : THREADS;
  const int blocks = (a->B + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->bucket_cap <= BUCKET_UNROLL) {
    return launch_kind<BUCKET_UNROLL>(a, p, blocks, s);
  }
  return launch_kind<0>(a, p, blocks, s);
}
