// Streamed point lookup: optional NF forward, a router-bracketed probe of
// the rank-ordered scan pool in 1024-row tiles, and the delta > run
// write-tier probe.
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
//  * per tile: searchsorted-left l over the tile's live rows
//    (min(plen - base, 1024)), as the TPU tile's search (which, above
//    every key of a tile whose rows are all live, ends one row past
//    them), then the identity window [l - W, l + 3W) with W the scan
//    pool's own window.  The
//    largest matching global index is the newest copy.  Tiles are visited
//    from t1 down, so the first tile with a match holds it and the walk
//    stops there;
//  * tiers: delta, then run, each matched in the window around its own
//    searchsorted-left (a tier keeps a row of +inf padding, so its
//    binary search gives the same), as `_finalize` merges them: a tier
//    match (TOMBSTONE included) beats the pool, and a TOMBSTONE becomes
//    -1.
//
// Bound on the card: memory latency.  A query is a chain of dependent
// reads, and with a batch's queries all in flight at once its time is
// the longest chain's.  The design cuts the chain's rounds:
//
//  * the router (64-128 KB at 2^24-2^25 rows) sits in shared memory.  The
//    blocks are persistent, one per SM, so each SM stages it once, with
//    cp.async while its threads evaluate the NF; the bracket search and
//    the walk then read no device memory (entries past what fits, for a
//    pool above ~58 M rows, are read from the router in device memory);
//  * a tile's search reads few sectors (`Isearch`, tier_device.cuh): each
//    round one aligned 64-byte block at a guess interpolated between the
//    tile's first key and the next tile's (the flow makes them near
//    uniform), so a query usually finds its row in one or two blocks
//    where a binary search reads 8 sectors in 11 rounds;
//  * the identity window reads hi four rows a load, then lo and pv only
//    where hi matched (`window_newest`);
//  * with tiers, half of each block probes the delta and the run for the
//    same queries while the other half probes the pool, each half
//    evaluating z itself: a read waits on the longer chain, not on their
//    sum.  The two tier searches step together, `Isearch` as well,
//    steered by each tier's first and last keys;
//  * the NF's weights are operands from the kernel-parameter bank.
#include <cstdint>

#include "nf_device.cuh"
#include "tier_device.cuh"

#define STREAM_TILE 1024
#define TOMBSTONE (-2)
#define THREADS 1024
#define HALF (THREADS / 2)

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
  int run_window;
  int dl_window;
  int r_smem;  // router entries to hold in shared memory (a multiple of 4)
  int chunk;   // queries a block serves per step (set by the launch)
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Barrier of the first `n` threads of the block (a multiple of 32).
__device__ __forceinline__ void bar_first(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

template <int NF>
__device__ __forceinline__ float query_z(const StreamArgs& a,
                                         const NFParams& p, int i) {
  const int64_t off = (int64_t)i * a.feat_dim;
  return a.use_flow ? nf_eval_row<NF>(a.feats, off, p) : __ldg(a.feats + off);
}

// The pool's payload for one query (-1: no tile holds its identity).
// `sr` holds router[0, staged).
__device__ __forceinline__ int pool_probe(const StreamArgs& a,
                                          const float* sr, int staged,
                                          int plen, int n_tiles, float q,
                                          int qhi, int qlo) {
  const int oz = ord_f32(q);
  const auto rt = [&](int t) {
    return t < staged ? sr[t] : __ldg(a.router + t);
  };
  // t1 + 1 = the number of tiles whose span starts at or below ord(z)
  int l = 0, h = n_tiles;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (add_wrap(ord_f32(rt(mid)), -2) <= oz) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  for (int t = l - 1; t >= 0; --t) {
    // spans end no higher as t falls: below this one, no tile can match
    const float next = rt(t + 1);
    if (add_wrap(ord_f32(next), 2) < oz) break;
    const int64_t base = (int64_t)t * STREAM_TILE;
    const int64_t live64 = (int64_t)plen - base;
    const int64_t rows64 = (int64_t)a.s_cap - base;
    const int live = live64 < STREAM_TILE ? (int)live64 : STREAM_TILE;
    const int rows = rows64 < STREAM_TILE ? (int)rows64 : STREAM_TILE;
    // the tile's first key and the next tile's steer the search
    int lb = Isearch::search(a.spk + base, live, q, rt(t), next);
    // the TPU tile's search runs bit_length(1024) = 11 rounds with its
    // reads clamped to the tile: above every key of a tile whose rows
    // are all live, its last round steps one past them
    if (lb == live && live == rows) ++lb;
    int pay = -1;
    if (window_newest(a.shi + base, a.slo + base, a.spv + base, live,
                      a.window, lb, qhi, qlo, pay) >= 0) {
      return pay;
    }
  }
  return -1;
}

// The newest tier copy of (qhi, qlo): the delta's, else the run's, else
// -1 (a TOMBSTONE passes through).
__device__ __forceinline__ int tier_probe(const StreamArgs& a, float q,
                                          int qhi, int qlo) {
  const int dn = __ldg(a.dlen);
  const int rn = __ldg(a.rlen);
  int dl, rl;
  isearch2(a.dpk, dn, a.rpk, rn, q, dl, rl);
  const int dv = window_pv(a.dhi, a.dlo, a.dpv, dn, a.dl_window, dl, qhi,
                           qlo);
  const int rv = window_pv(a.rhi, a.rlo, a.rpv, rn, a.run_window, rl, qhi,
                           qlo);
  return dv != -1 ? dv : rv;
}

template <int NF>
__global__ void __launch_bounds__(THREADS, 1)
    streamed_lookup_kernel(const StreamArgs a,
                           const __grid_constant__ NFParams p) {
  extern __shared__ __align__(16) float s_router[];
  __shared__ int s_tier[2][HALF];
  // with tiers: the first half of the block probes the pool for a chunk of
  // queries, the second half probes the tiers for the same queries
  const bool tiers = a.probe_tiers != 0;
  const int per = tiers ? HALF : THREADS;
  const bool prober = tiers && threadIdx.x >= HALF;
  const int t = prober ? threadIdx.x - HALF : threadIdx.x;
  const int n_chunks = (a.B + a.chunk - 1) / a.chunk;

  int plen = 0, n_tiles = 0, staged = 0;
  if (!prober) {
    plen = __ldg(a.slen);
    n_tiles = (int)(((int64_t)plen + STREAM_TILE - 1) / STREAM_TILE);
    staged = min(n_tiles + 1, a.r_smem);
    for (int c = t; 4 * c < staged; c += per) {
      cp_async16(s_router + 4 * c, a.router + 4 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  bool staging = !prober;
  int parity = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int i = c * a.chunk + t;
    const bool live = t < a.chunk && i < a.B;
    float q = 0.f;
    int qhi = 0, qlo = 0;
    if (live) {
      q = query_z<NF>(a, p, i);
      qhi = __ldg(a.qhi + i);
      qlo = __ldg(a.qlo + i);
    }
    int result = -1;
    if (prober) {
      if (live) s_tier[parity][t] = tier_probe(a, q, qhi, qlo);
    } else {
      if (staging) {
        asm volatile("cp.async.wait_all;\n" ::);
        bar_first(per);
        staging = false;
      }
      if (live) {
        result = pool_probe(a, s_router, staged, plen, n_tiles, q, qhi, qlo);
      }
    }
    if (tiers) {
      __syncthreads();
      if (!prober && live) {
        const int tv = s_tier[parity][t];
        result = tv != -1 ? tv : result;
      }
    }
    if (!prober && live) {
      a.out_pay[i] = result == TOMBSTONE ? -1 : result;
      a.out_z[i] = q;
    }
    parity ^= 1;
  }
  if (staging) asm volatile("cp.async.wait_all;\n" ::);
}

extern "C" int streamed_lookup_launch(StreamArgs* a, const NFParams* p,
                                      void* stream) {
  if (a->B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nf_dispatch(nf_kind(*p, a->use_flow != 0), [&](auto k) {
    constexpr int NF = decltype(k)::value;
    // the router entries that fit beside the kernel's static shared memory
    static int fit = -1;
    if (fit < 0) {
      int dev = 0, optin = 0;
      cudaFuncAttributes fa;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
      cudaFuncGetAttributes(&fa, streamed_lookup_kernel<NF>);
      fit = ((optin - static_cast<int>(fa.sharedSizeBytes)) / 4) & ~3;
    }
    if (a->r_smem > fit) a->r_smem = fit;
    const int smem = 4 * a->r_smem;
    static int smem_set = 0;  // the dynamic shared memory allowed so far
    static int full_at = -1, full = 1;
    if (smem > smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          streamed_lookup_kernel<NF>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = smem;
    }
    if (full_at != smem) {
      full = resident_blocks(streamed_lookup_kernel<NF>, THREADS, smem);
      full_at = smem;
    }
    // spread the batch over every resident block, a chunk each step
    const int per = a->probe_tiers ? HALF : THREADS;
    const int even = (int)(((int64_t)a->B + full - 1) / full);
    a->chunk = even < per ? even : per;
    const int n_chunks = (a->B + a->chunk - 1) / a->chunk;
    const int blocks = n_chunks < full ? n_chunks : full;
    streamed_lookup_kernel<NF><<<blocks, THREADS, smem, s>>>(*a, *p);
    return static_cast<int>(cudaGetLastError());
  });
}
