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
//
// Every search here returns searchsorted-left over the live rows, so a
// kernel that finds the index another way (the range kernel's merge
// cursors) matches the same window with `window_pv` and returns the same
// payload as `probe_tier`.
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

// Widest window that `window_pv` reads in aligned four-row loads (4W
// rows span at most W + 1 of them, and their match bits fit in 64).
#define WINDOW_VEC_MAX 8

// Payload of the newest row matching (qhi, qlo) in the window
// [l - W, l + 3W) around a lower bound l, clipped to the live rows
// [0, n); -1 if none (a matched TOMBSTONE passes through).  Two rounds:
// hi over the whole window, four rows per 16-byte load (hi's base is
// 16-byte aligned and its capacity a multiple of 4, which the wrappers
// check), then lo and pv only where hi matched, newest first.  A window
// wider than WINDOW_VEC_MAX rows a side is read row by row.
__device__ __forceinline__ int window_pv(const int* hi, const int* lo,
                                         const int* pv, int n, int window,
                                         int l, int qhi, int qlo) {
  const int j0 = max(l - window, 0);
  const int j1 = min(l + 3 * window, n);
  if (j0 >= j1) return -1;
  if (window > WINDOW_VEC_MAX) {
    int last = -1;
    for (int j = j0; j < j1; ++j) {
      if (__ldg(hi + j) == qhi && __ldg(lo + j) == qlo) last = j;
    }
    return last >= 0 ? __ldg(pv + last) : -1;
  }
  const int k0 = j0 >> 2;
  const int k1 = (j1 - 1) >> 2;
  const int4* hv = reinterpret_cast<const int4*>(hi);
  unsigned long long m = 0;  // bit b: row 4 * k0 + b matched on hi
#pragma unroll
  for (int c = 0; c <= WINDOW_VEC_MAX; ++c) {
    if (k0 + c <= k1) {
      const int4 v = __ldg(hv + k0 + c);
      m |= (unsigned long long)((v.x == qhi) | (v.y == qhi) << 1 |
                                (v.z == qhi) << 2 | (v.w == qhi) << 3)
           << (4 * c);
    }
  }
  const int base = 4 * k0;
  m &= ~((1ull << (j0 - base)) - 1ull);
  if (j1 - base < 64) m &= (1ull << (j1 - base)) - 1ull;
  while (m) {
    const int b = 63 - __clzll(m);
    const int o = __ldg(lo + base + b);
    const int v = __ldg(pv + base + b);
    if (o == qlo) return v;
    m &= ~(1ull << b);
  }
  return -1;
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
