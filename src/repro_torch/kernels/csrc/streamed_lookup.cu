// Streamed point lookup: optional NF forward, a router-bracketed probe of
// the rank-ordered scan pool in 1024-row tiles, and the delta > run
// write-tier probe, one thread per query.
//
// Replaces `streamed_lookup_pallas` (src/repro/kernels/streamed_lookup.py),
// the rung of the point-read ladder that serves from the scan pool (the
// static structure's keys in rank order) instead of the tree.  Semantics
// follow its `_kernel` step for step:
//
//  * z: `nf_eval` (nf_device.cuh), the routine of the NF, lookup and range
//    kernels, so z is bit-equal to the fused rung's z and to the stored
//    keys' z; with the flow off, z is feats[:, 0].  z is an output;
//  * tiles: tile t holds pool rows [1024 t, 1024 t + 1024); router[t] is
//    its first key (+inf past the pool, one trailing +inf sentinel).  The
//    TPU kernel probes tile t when some query of its query tile has
//    ord(z) in [ord(router[t]) - 2, ord(router[t+1]) + 2], with `_ord_f32`'s
//    int32 total-order image (computed here with the same int32
//    wrap-around).  Both ends of that span rise with t, so a query's own
//    tiles are one contiguous range [t0, t1]: a binary search over the
//    router gives t1, and the walk down from t1 stops at the first tile
//    whose span ends below ord(z) (t0 - 1).  A tile outside the bracket
//    cannot hold the query's key, and matching is by identity, so the
//    per-query bracket finds what the per-query-tile gate finds;
//  * per tile: `probe_index` (tier_device.cuh) over the tile's live rows
//    (min(plen - base, 1024)): `lower_bound` in 11 rounds with reads
//    clamped to the tile, as the TPU tile's search, then the identity
//    window [l - W, l + 3W) with W the scan pool's own window.  The
//    largest matching global index is the newest copy.  Tiles are visited
//    from t1 down, so the first tile with a match holds it and the walk
//    stops there;
//  * tiers: delta, then run, each by `probe_tier`, as `_finalize` merges
//    them: a tier match (TOMBSTONE included) beats the pool, and a
//    TOMBSTONE becomes -1.
//
// Bound on the card: memory latency.  Per query, a chain of dependent
// reads: about 15 router reads (the router is at most 128 KB for a
// 2^25-row pool and stays in L2), 11 reads of one 4 KB tile, the window's
// 4W identity reads, then the tier searches.  A simple design first: one
// query per thread, router and pool through the read-only path (__ldg),
// 64-bit row offsets.  The TPU kernel's pipeline (pool tiles double-
// buffered into fast memory) would map to a shared-memory router and
// cp.async/TMA tiles; not done here.
#include <cstdint>

#include "nf_device.cuh"
#include "tier_device.cuh"

#define STREAM_TILE 1024
#define TILE_ITERS 11  // bit_length(STREAM_TILE), as the TPU tile's search
#define TOMBSTONE (-2)

struct StreamArgs {
  const float* feats;
  const int* qhi;
  const int* qlo;
  const float* spk;
  const int* shi;
  const int* slo;
  const int* spv;
  const int* slen;
  const float* router;
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
  int s_cap;
  int window;
  int probe_tiers;
  int run_cap;
  int run_iters;
  int run_window;
  int dl_cap;
  int dl_iters;
  int dl_window;
};

// `_ord_f32`: the int32 total-order image of an f32 (negative bit
// patterns map to INT_MIN - i; -0.0 and +0.0 both map to 0).
__device__ __forceinline__ int ord_f32(float x) {
  const int i = __float_as_int(x);
  return i < 0 ? static_cast<int>(0x80000000u - static_cast<unsigned>(i)) : i;
}

// x + d in int32 with wrap-around, as the TPU kernel's int32 slack.
__device__ __forceinline__ int add_wrap(int x, int d) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(d));
}

template <int MAXW>
__global__ void streamed_lookup_kernel(const StreamArgs a, const NFParams p) {
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
  const int oz = ord_f32(q);

  // tiles holding live rows: [0, n_tiles)
  const int plen = __ldg(a.slen);
  const int n_tiles = (int)(((int64_t)plen + STREAM_TILE - 1) / STREAM_TILE);
  // t1 + 1 = the number of tiles whose span starts at or below ord(z)
  int l = 0, h = n_tiles;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (add_wrap(ord_f32(__ldg(a.router + mid)), -2) <= oz) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  int result = -1;
  for (int t = l - 1; t >= 0; --t) {
    // spans end no higher as t falls: below this one, no tile can match
    if (add_wrap(ord_f32(__ldg(a.router + t + 1)), 2) < oz) break;
    const int64_t base = (int64_t)t * STREAM_TILE;
    const int64_t live64 = (int64_t)plen - base;
    const int64_t rows64 = (int64_t)a.s_cap - base;
    const int live = live64 < STREAM_TILE ? (int)live64 : STREAM_TILE;
    const int rows = rows64 < STREAM_TILE ? (int)rows64 : STREAM_TILE;
    const int j = probe_index(a.spk + base, a.shi + base, a.slo + base, live,
                              rows, TILE_ITERS, a.window, q, qhi, qlo);
    if (j >= 0) {
      result = __ldg(a.spv + base + j);
      break;
    }
  }

  if (a.probe_tiers) {
    const int dl = probe_tier(a.dpk, a.dhi, a.dlo, a.dpv, __ldg(a.dlen),
                              a.dl_cap, a.dl_iters, a.dl_window, q, qhi,
                              qlo);
    const int rn = probe_tier(a.rpk, a.rhi, a.rlo, a.rpv, __ldg(a.rlen),
                              a.run_cap, a.run_iters, a.run_window, q, qhi,
                              qlo);
    result = dl != -1 ? dl : (rn != -1 ? rn : result);
  }
  if (result == TOMBSTONE) result = -1;
  a.out_pay[i] = result;
  a.out_z[i] = q;
}

extern "C" int streamed_lookup_launch(const StreamArgs* a, const NFParams* p,
                                      void* stream) {
  if (a->B <= 0) return 0;
  const int threads = 256;
  const int blocks = (a->B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = a->use_flow ? nf_max_width(*p) : 1;
  if (w <= 4) {
    streamed_lookup_kernel<4><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 8) {
    streamed_lookup_kernel<8><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 16) {
    streamed_lookup_kernel<16><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 32) {
    streamed_lookup_kernel<32><<<blocks, threads, 0, s>>>(*a, *p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
