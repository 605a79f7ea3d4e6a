// Sorted-pool search and identity probe shared by the port's lookup,
// streamed-lookup and range kernels.
//
// Replaces `lower_bound` and `probe_pool_index`/`probe_pool`
// (src/repro/kernels/fused_lookup.py), the helpers that
// `fused_lookup_pallas`, `streamed_lookup_pallas` and
// `fused_range_scan_pallas` all compile.  A pool is one sorted tier (the run,
// the delta, the range path's scan pool, or one 1024-row tile of it):
// positioning keys f32 (+inf past the live length), identity halves as
// int32 bit views, payloads i32.  Every kernel locates and matches a tier
// with this code, so a point read (either rung) and a range scan can
// never disagree on which copy of an identity is the newest.
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

// Index of the newest row matching (qhi, qlo) in one sorted tier (-1:
// none).  The key q only locates: the window [l - W, l + 3W) around its
// lower bound, clipped to the live rows, is matched by identity alone,
// and the highest matching index (the newest copy) wins.
__device__ __forceinline__ int probe_index(const float* pk, const int* hi,
                                           const int* lo, int n, int cap,
                                           int iters, int window, float q,
                                           int qhi, int qlo) {
  if (n <= 0) return -1;
  const int l = lower_bound(pk, n, cap, iters, q);
  int last = -1;
  const int w0 = l - window;
  for (int w = 0; w < 4 * window; ++w) {
    const int j = w0 + w;
    if (j < 0 || j >= n) continue;
    if (__ldg(hi + j) == qhi && __ldg(lo + j) == qlo) last = j;
  }
  return last;
}

// Newest payload matching (qhi, qlo) in one sorted tier (-1: none; a
// matched TOMBSTONE passes through for the caller).
__device__ __forceinline__ int probe_tier(const float* pk, const int* hi,
                                          const int* lo, const int* pv,
                                          int n, int cap, int iters,
                                          int window, float q, int qhi,
                                          int qlo) {
  const int j = probe_index(pk, hi, lo, n, cap, iters, window, q, qhi, qlo);
  return j >= 0 ? __ldg(pv + j) : -1;
}
