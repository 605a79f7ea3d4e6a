// Fused range scan: endpoint NF, lower bounds in three sorted pools, and a
// tier-merged, identity-deduplicated emission of up to `scan_cap`
// candidates, one thread per [lo, hi) range query.
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
//  * merge: `scan_cap` rounds, each taking the smallest head key; on equal
//    keys the delta goes before the run before the scan pool, and within
//    a pool index order holds.  A scan-pool candidate whose identity has
//    a copy in the run or the delta is superseded, and a run candidate
//    with a copy in the delta; the copy is found by `probe_tier` at the
//    candidate's own key, the point kernel's probe.  A TOMBSTONE candidate
//    is dropped.  Valid payloads compact into lanes 0..cnt-1, the rest of
//    the row is -1.
//
// The TPU kernel runs all `scan_cap` rounds in lockstep over a tile; here a
// thread stops at the first round with no candidate left (every later
// round of the reference is a no-op), and probes only the tiers newer than
// the candidate's own (the reference's other probe result is unused).
//
// Bound on the card: memory latency.  Each candidate of a scan-pool span
// costs two dependent binary searches (delta and run probes) before the
// next candidate can be judged, and the output row is written by one
// thread, 4 bytes at a time (scan_cap 128: a 512-byte row per thread, so
// the stores of a warp are 32 rows apart and not coalesced).  A simple
// design first: one query per thread, pools through the read-only path
// (__ldg), 64-bit row offsets.
#include <cstdint>

#include "nf_device.cuh"
#include "tier_device.cuh"

#define TOMBSTONE (-2)

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

template <int MAXW>
__device__ __forceinline__ float endpoint_z(const float* feats, int i,
                                            int feat_dim, int use_flow,
                                            const NFParams& p,
                                            const float* sw) {
  if (!use_flow) return __ldg(feats + (int64_t)i * feat_dim);
  float x[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    x[k] = (k < p.dim) ? __ldg(feats + (int64_t)i * feat_dim + k) : 0.f;
  }
  return nf_eval<MAXW>(x, p, sw);
}

template <int MAXW>
__global__ void range_scan_kernel(const ScanArgs a, const NFParams p) {
  __shared__ float sw[NF_MAX_W];
  if (a.use_flow) nf_stage_weights(p, sw);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;

  const float zlo = endpoint_z<MAXW>(a.flo, i, a.feat_dim, a.use_flow, p, sw);
  const float zhi = endpoint_z<MAXW>(a.fhi, i, a.feat_dim, a.use_flow, p, sw);
  a.out_zlo[i] = zlo;
  a.out_zhi[i] = zhi;

  const int s_len = __ldg(a.slen);
  const int s0 = lower_bound(a.spk, s_len, a.s_cap, a.s_iters, zlo);
  const int s1 = lower_bound(a.spk, s_len, a.s_cap, a.s_iters, zhi);
  int r_len = 0, d_len = 0, r0 = 0, r1 = 0, d0 = 0, d1 = 0;
  if (a.probe_tiers) {
    r_len = __ldg(a.rlen);
    d_len = __ldg(a.dlen);
    r0 = lower_bound(a.rpk, r_len, a.run_cap, a.run_iters, zlo);
    r1 = lower_bound(a.rpk, r_len, a.run_cap, a.run_iters, zhi);
    d0 = lower_bound(a.dpk, d_len, a.dl_cap, a.dl_iters, zlo);
    d1 = lower_bound(a.dpk, d_len, a.dl_cap, a.dl_iters, zhi);
  }
  const int total = max(s1 - s0, 0) + max(r1 - r0, 0) + max(d1 - d0, 0);

  const float inf = __int_as_float(0x7f800000);
  int* row = a.out_pv + (int64_t)i * a.scan_cap;
  int it = s0, ir = r0, id = d0, cnt = 0;
  for (int step = 0; step < a.scan_cap; ++step) {
    const float t_pk = it < s1 ? __ldg(a.spk + it) : inf;
    const float r_pk = ir < r1 ? __ldg(a.rpk + ir) : inf;
    const float d_pk = id < d1 ? __ldg(a.dpk + id) : inf;
    const float m = fminf(t_pk, fminf(r_pk, d_pk));
    if (!(m < inf)) break;
    int chi, clo, cpv;
    bool superseded = false;
    if (d_pk == m) {
      chi = __ldg(a.dhi + id);
      clo = __ldg(a.dlo + id);
      cpv = __ldg(a.dpv + id);
      ++id;
    } else if (r_pk == m) {
      chi = __ldg(a.rhi + ir);
      clo = __ldg(a.rlo + ir);
      cpv = __ldg(a.rpv + ir);
      ++ir;
      superseded = probe_tier(a.dpk, a.dhi, a.dlo, a.dpv, d_len, a.dl_cap,
                              a.dl_iters, a.dl_window, m, chi, clo) != -1;
    } else {
      chi = __ldg(a.shi + it);
      clo = __ldg(a.slo + it);
      cpv = __ldg(a.spv + it);
      ++it;
      if (a.probe_tiers) {
        superseded =
            probe_tier(a.dpk, a.dhi, a.dlo, a.dpv, d_len, a.dl_cap,
                       a.dl_iters, a.dl_window, m, chi, clo) != -1 ||
            probe_tier(a.rpk, a.rhi, a.rlo, a.rpv, r_len, a.run_cap,
                       a.run_iters, a.run_window, m, chi, clo) != -1;
      }
    }
    if (!superseded && cpv != TOMBSTONE) row[cnt++] = cpv;
  }
  for (int c = cnt; c < a.scan_cap; ++c) row[c] = -1;
  a.out_cnt[i] = cnt;
  a.out_tot[i] = total;
}

extern "C" int range_scan_launch(const ScanArgs* a, const NFParams* p,
                                 void* stream) {
  if (a->B <= 0) return 0;
  const int threads = 256;
  const int blocks = (a->B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = a->use_flow ? nf_max_width(*p) : 1;
  if (w <= 4) {
    range_scan_kernel<4><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 8) {
    range_scan_kernel<8><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 16) {
    range_scan_kernel<16><<<blocks, threads, 0, s>>>(*a, *p);
  } else if (w <= 32) {
    range_scan_kernel<32><<<blocks, threads, 0, s>>>(*a, *p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
