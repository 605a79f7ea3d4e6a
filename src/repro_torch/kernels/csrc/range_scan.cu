// Fused range scan: endpoint NF, lower bounds in three sorted pools, and a
// tier-merged, identity-deduplicated emission of up to `scan_cap`
// candidates, one warp per [lo, hi) range query.
//
// Replaces `fused_range_scan_pallas` (src/repro/kernels/range_scan.py),
// the kernel behind every `scan_batch` of the flat backend.  Semantics
// follow its `_kernel` step for step:
//
//  * endpoints: z of both ends from `nf_eval` (nf_device.cuh), the routine
//    the NF and lookup kernels use, so a stored key and an endpoint of the
//    same identity have bit-equal z; with the flow off, z is the f32 key.
//    Both are outputs (zlo, zhi);
//  * location: `lower_bound` (tier_device.cuh) of zlo and zhi in the scan
//    pool (the static structure's keys in rank order), the run and the
//    delta: [a, b) holds exactly the entries with zlo <= pk < zhi, so an
//    empty or inverted range has no candidates.  `tot` counts every
//    candidate over the three pools, superseded copies and tombstones
//    included: tot > scan_cap marks a truncated query;
//  * merge: the first `scan_cap` candidates in order of key (as f32, so
//    -0.0 == +0.0), then pool (delta, run, scan pool), then index within
//    a pool.  A scan-pool candidate whose identity has a copy in the run
//    or the delta is superseded, and a run candidate with a copy in the
//    delta; the copy is the one a tier probe finds at the candidate's own
//    key: the newest identity match in the window [l - W, l + 3W) around
//    the key's lower bound l in that tier, clipped to its live rows.  A
//    TOMBSTONE candidate is dropped.  Valid payloads compact into lanes
//    0..cnt-1, the rest of the row is -1.
//
// Bound on the card: memory latency, then the output rows.  The design:
//
//  * a warp per range, eight a block, so a batch of 16,384 ranges fills
//    the card;
//  * the six endpoint lower bounds run at once, five lanes each, as
//    6-ary searches: about 10 rounds over the scan pool where a binary
//    search takes 26;
//  * the merge takes up to 32 candidates a round.  Each lane reads the
//    next head of each pool (coalesced), counts by shuffles how many heads
//    of the other pools go before its own (the merge path's co-rank), and
//    the candidate of rank r lands in lane r through shared memory;
//  * the probe's lower bound comes from the merge itself: the candidates
//    before key m in the merged order are exactly the rows below m, so
//    lower_bound(tier, m) = the tier's cursor + its heads below m (the
//    cursors only move forward inside [r0, r1] and [d0, d1]), carried
//    across rounds for a key whose equal copies span two of them.  No
//    binary search runs per candidate.  The candidate's own row and the
//    windows' hi reads (four rows a load; a window may reach past the
//    range's own slice) issue in one round, lo and pv where hi matched
//    in a second (`window_pv`);
//  * emitted payloads compact by a ballot prefix count, and the row,
//    then its -1 tail, is written coalesced.
#include <cstdint>

#include "nf_device.cuh"
#include "tier_device.cuh"

#define TOMBSTONE (-2)
#define WARPS 8
#define FULL 0xffffffffu

struct ScanArgs {
  const float* flo;
  const float* fhi;
  const float* spk;
  const int* shi;
  const int* slo;
  const int* spv;
  const int* slen;
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
  int* out_pv;
  int* out_cnt;
  int* out_tot;
  float* out_zlo;
  float* out_zhi;
  int B;
  int feat_dim;
  int use_flow;
  int scan_cap;
  int s_cap;
  int s_iters;
  int probe_tiers;
  int run_cap;
  int run_iters;
  int run_window;
  int dl_cap;
  int dl_iters;
  int dl_window;
  int pad_;
};

// One merged candidate, as the lane that ranked it hands it over.
struct Slot {
  int pool;  // 0 delta, 1 run, 2 scan pool
  int idx;
  float key;
  int ld;    // lower_bound(delta, key)
  int lr;    // lower_bound(run, key)
};

template <int NF>
__device__ __forceinline__ float endpoint_z(const float* feats, int i,
                                            int feat_dim, int use_flow,
                                            const NFParams& p) {
  if (!use_flow) return __ldg(feats + (int64_t)i * feat_dim);
  return nf_eval_row<NF>(feats, (int64_t)i * feat_dim, p);
}

template <int NF>
__global__ void __launch_bounds__(WARPS * 32)
    range_scan_kernel(const ScanArgs a, const __grid_constant__ NFParams p) {
  __shared__ Slot slots[WARPS][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= a.B) return;  // the whole warp: no barrier follows
  const unsigned below = (1u << lane) - 1u;
  const float inf = __int_as_float(0x7f800000);

  float z = 0.f;
  if (lane < 2) {
    z = endpoint_z<NF>(lane ? a.fhi : a.flo, i, a.feat_dim, a.use_flow, p);
  }
  const float zlo = __shfl_sync(FULL, z, 0);
  const float zhi = __shfl_sync(FULL, z, 1);
  if (lane == 0) {
    a.out_zlo[i] = zlo;
    a.out_zhi[i] = zhi;
  }

  // the six endpoint lower bounds, five lanes each: group g = lane / 5
  // searches (zlo, zhi) in the scan pool (g 0-1), the run (2-3) or the
  // delta (4-5) by a 6-ary search.  Each round every lane of a group
  // reads one of five pivots spread over the bracket [l, h); the keys
  // are sorted, so the pivots below q are a prefix, and their count
  // picks the next bracket.  The bracket holds searchsorted-left
  // throughout and closes on it, as `lower_bound` does.
  const int s_len = __ldg(a.slen);
  const int r_len = a.probe_tiers ? __ldg(a.rlen) : 0;
  const int d_len = a.probe_tiers ? __ldg(a.dlen) : 0;
  const int g = lane / 5, r = lane % 5;
  const float* gpk = g < 2 ? a.spk : (g < 4 ? a.rpk : a.dpk);
  const float qe = (g & 1) ? zhi : zlo;
  int l = 0;
  int h = g < 2 ? s_len : (g < 4 ? r_len : (g < 6 ? d_len : 0));
  while (__any_sync(FULL, l < h)) {
    const int64_t d = h - l;
    const int piv = l + (int)(d * (r + 1) / 6);
    const bool below = l < h && __ldg(gpk + piv) < qe;
    const unsigned bits = (__ballot_sync(FULL, below) >> (5 * g)) & 31u;
    if (l < h) {
      const int t = __popc(bits);
      const int lo_t = l + (int)(d * t / 6);           // pivot t - 1 + ...
      const int hi_t = l + (int)(d * (t + 1) / 6);     // pivot t
      if (t > 0) l = lo_t + 1;
      if (t < 5) h = hi_t;
    }
  }
  const int lb = l;
  const int s0 = __shfl_sync(FULL, lb, 0), s1 = __shfl_sync(FULL, lb, 5);
  const int r0 = __shfl_sync(FULL, lb, 10), r1 = __shfl_sync(FULL, lb, 15);
  const int d0 = __shfl_sync(FULL, lb, 20), d1 = __shfl_sync(FULL, lb, 25);
  const int se = max(s1, s0), re = max(r1, r0), de = max(d1, d0);
  const int total = (se - s0) + (re - r0) + (de - d0);
  const int considered = min(total, a.scan_cap);

  int* row = a.out_pv + (int64_t)i * a.scan_cap;
  Slot* slot = slots[warp];
  int cs = s0, cr = r0, cd = d0;  // cursors: candidates merged so far
  int cnt = 0;
  bool have_prev = false;         // the last merged key and its bounds
  float k_prev = 0.f;
  int ld_prev = 0, lr_prev = 0;
  for (int done = 0; done < considered;) {
    const int c = min(32, considered - done);
    const bool dv = cd + lane < de, rv = cr + lane < re, sv = cs + lane < se;
    const float dk = dv ? __ldg(a.dpk + cd + lane) : inf;
    const float rk = rv ? __ldg(a.rpk + cr + lane) : inf;
    const float sk = sv ? __ldg(a.spk + cs + lane) : inf;
    // heads of each pool below (lt) or at most (le) this lane's heads;
    // invalid heads are +inf and count for nothing.  Each pool's heads
    // are compared only as far as it has valid ones
    const int nd = __popc(__ballot_sync(FULL, dv));
    const int nr = __popc(__ballot_sync(FULL, rv));
    const int ns = (nd || nr) ? __popc(__ballot_sync(FULL, sv)) : 0;
    int d_ltD = 0, d_ltR = 0, d_ltS = 0;
    int r_leD = 0, r_ltD = 0, r_ltR = 0, r_ltS = 0;
    int s_leD = 0, s_ltD = 0, s_leR = 0, s_ltR = 0;
    for (int j = 0; j < nd; ++j) {
      const float dj = __shfl_sync(FULL, dk, j);
      d_ltD += dj < dk;
      r_leD += dj <= rk;
      r_ltD += dj < rk;
      s_leD += dj <= sk;
      s_ltD += dj < sk;
    }
    for (int j = 0; j < nr; ++j) {
      const float rj = __shfl_sync(FULL, rk, j);
      d_ltR += rj < dk;
      r_ltR += rj < rk;
      s_leR += rj <= sk;
      s_ltR += rj < sk;
    }
    for (int j = 0; j < ns; ++j) {
      const float sj = __shfl_sync(FULL, sk, j);
      d_ltS += sj < dk;
      r_ltS += sj < rk;
    }
    // rank in the merged order: equal keys go delta, run, scan pool
    const int d_rank = lane + d_ltR + d_ltS;
    const int r_rank = lane + r_leD + r_ltS;
    const int s_rank = lane + s_leD + s_leR;
    const bool d_in = dv && d_rank < c, r_in = rv && r_rank < c,
               s_in = sv && s_rank < c;
    if (d_in) {
      const bool cont = have_prev && dk == k_prev;
      slot[d_rank] = Slot{0, cd + lane, dk, cont ? ld_prev : cd + d_ltD,
                          cont ? lr_prev : cr + d_ltR};
    }
    if (r_in) {
      const bool cont = have_prev && rk == k_prev;
      slot[r_rank] = Slot{1, cr + lane, rk, cont ? ld_prev : cd + r_ltD,
                          cont ? lr_prev : cr + r_ltR};
    }
    if (s_in) {
      const bool cont = have_prev && sk == k_prev;
      slot[s_rank] = Slot{2, cs + lane, sk, cont ? ld_prev : cd + s_ltD,
                          cont ? lr_prev : cr + s_ltR};
    }
    cd += __popc(__ballot_sync(FULL, d_in));
    cr += __popc(__ballot_sync(FULL, r_in));
    cs += __popc(__ballot_sync(FULL, s_in));
    __syncwarp();

    bool emit = false;
    int cpv = 0;
    Slot me{0, 0, 0.f, 0, 0};
    if (lane < c) {
      me = slot[lane];
      const int* hi = me.pool == 0 ? a.dhi : (me.pool == 1 ? a.rhi : a.shi);
      const int* lo = me.pool == 0 ? a.dlo : (me.pool == 1 ? a.rlo : a.slo);
      const int* pv = me.pool == 0 ? a.dpv : (me.pool == 1 ? a.rpv : a.spv);
      const int chi = __ldg(hi + me.idx);
      const int clo = __ldg(lo + me.idx);
      cpv = __ldg(pv + me.idx);
      // the delta's copy for run and scan-pool candidates, the run's for
      // scan-pool candidates
      const bool newer_d = me.pool > 0 && a.probe_tiers;
      const bool newer_r = me.pool == 2 && a.probe_tiers;
      const int dw = newer_d ? window_pv(a.dhi, a.dlo, a.dpv, d_len,
                                         a.dl_window, me.ld, chi, clo)
                             : -1;
      const int rw = newer_r ? window_pv(a.rhi, a.rlo, a.rpv, r_len,
                                         a.run_window, me.lr, chi, clo)
                             : -1;
      emit = dw == -1 && rw == -1 && cpv != TOMBSTONE;
    }
    const unsigned em = __ballot_sync(FULL, emit);
    if (emit) row[cnt + __popc(em & below)] = cpv;
    cnt += __popc(em);
    k_prev = __shfl_sync(FULL, me.key, c - 1);
    ld_prev = __shfl_sync(FULL, me.ld, c - 1);
    lr_prev = __shfl_sync(FULL, me.lr, c - 1);
    have_prev = true;
    done += c;
    __syncwarp();
  }
  for (int t = cnt + lane; t < a.scan_cap; t += 32) row[t] = -1;
  if (lane == 0) {
    a.out_cnt[i] = cnt;
    a.out_tot[i] = total;
  }
}

extern "C" int range_scan_launch(const ScanArgs* a, const NFParams* p,
                                 void* stream) {
  if (a->B <= 0) return 0;
  const int blocks = (a->B + WARPS - 1) / WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nf_dispatch(nf_kind(*p, a->use_flow != 0), [&](auto k) {
    constexpr int NF = decltype(k)::value;
    range_scan_kernel<NF><<<blocks, WARPS * 32, 0, s>>>(*a, *p);
    return static_cast<int>(cudaGetLastError());
  });
}
