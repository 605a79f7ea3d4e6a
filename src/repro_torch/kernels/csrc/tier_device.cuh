// Sorted-pool search and identity probe shared by the port's lookup and
// range kernels.
//
// Replaces `lower_bound` and `probe_pool_index`/`probe_pool`
// (src/repro/kernels/fused_lookup.py), the helpers that both
// `fused_lookup_pallas` and `fused_range_scan_pallas` compile.  A pool is
// one sorted tier (the run, the delta, or the range path's scan pool):
// positioning keys f32 (+inf past the live length), identity halves as
// int32 bit views, payloads i32.  Both kernels locate and match a tier
// with this code, so a point read and a range scan can never disagree on
// which copy of an identity is the newest.
#pragma once

#include <cuda_runtime.h>

// Leftmost index in [0, n] with pk[i] >= q (== searchsorted-left over
// the live length n) as `iters` rounds of binary search; 2^iters must
// exceed n.  Reads are clamped to the pool's capacity `cap`.
__device__ __forceinline__ int lower_bound(const float* pk, int n, int cap,
                                           int iters, float q) {
  int l = 0, h = n;
  for (int it = 0; it < iters; ++it) {
    const int mid = (l + h) >> 1;
    const int m = mid < cap ? mid : cap - 1;
    if (__ldg(pk + m) < q) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return l;
}

// Newest payload matching (qhi, qlo) in one sorted tier (-1: none; a
// matched TOMBSTONE passes through for the caller).  The key q only
// locates: the window [l - W, l + 3W) around its lower bound is matched
// by identity alone, and the highest matching index (the newest copy)
// wins.
__device__ __forceinline__ int probe_tier(const float* pk, const int* hi,
                                          const int* lo, const int* pv,
                                          int n, int cap, int iters,
                                          int window, float q, int qhi,
                                          int qlo) {
  if (n <= 0) return -1;
  const int l = lower_bound(pk, n, cap, iters, q);
  int last = -1;
  const int w0 = l - window;
  for (int w = 0; w < 4 * window; ++w) {
    const int j = w0 + w;
    if (j < 0 || j >= n) continue;
    if (__ldg(hi + j) == qhi && __ldg(lo + j) == qlo) last = j;
  }
  return last >= 0 ? __ldg(pv + last) : -1;
}
