// Sorted-pool search and identity probe shared by the port's lookup,
// streamed-lookup and range kernels.
//
// Replaces `lower_bound` and `probe_pool_index`/`probe_pool`
// (src/repro/kernels/fused_lookup.py), the helpers that
// `fused_lookup_pallas`, `streamed_lookup_pallas` and
// `fused_range_scan_pallas` all compile.  A pool is one sorted tier (the run,
// the delta, the range path's scan pool, or one 1024-row tile of it):
// positioning keys f32 (+inf past the live length), identity halves as
// int32 bit views, payloads i32.  Every kernel matches a tier's identity
// window with this code, so a point read (either rung) and a range scan
// can never disagree on which copy of an identity is the newest.
//
// Each kernel finds a tier's searchsorted-left over its live rows its own
// way (the point kernel's binary searches, the range kernel's merge
// cursors, the streamed kernel's `Isearch` below), and every way
// gives the same index, so the same window and the same payload as the
// plain versions' `_probe_tier_plain`.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Widest window that `window_newest` reads in aligned four-row loads (4W
// rows span at most W + 1 of them, and their match bits fit in 64).
#define WINDOW_VEC_MAX 8

// Rows one round of `Isearch` reads: one aligned 32-byte sector, four
// rows a 16-byte load.
#define ISEARCH_ROWS 8
// The widest bracket a round interpolates in (a wider one bisects), and
// how many rounds may interpolate.
#define ISEARCH_NARROW 4096
#define ISEARCH_GUESSES 4

// Searchsorted-left of q over the sorted live rows [0, n) of pk, reading
// few sectors: a batch's searches are bound by how many device-memory
// sectors they touch more than by how many rounds they wait (a 4-ary
// search, three sectors a round, is slower than a binary one, and a
// block of 8 rows faster than one of 16 or 32; PERF.md section 6).  Each
// round reads one aligned sector of ISEARCH_ROWS rows and counts the rows
// of the bracket [l, h] (which holds the answer) that lie in it below
// q: if some but not all are, the answer is exact; if none are, the
// bracket ends at the block's first row; if all are, it starts after the
// block's last.  Where the block lies: while the bracket is wide, at its
// middle, so that a batch's searches share their first blocks and find
// them in L2; once it is narrow (ISEARCH_NARROW rows, a 1,024-row tile
// from the start), at q interpolated between kl and kh, keys bounding
// the bracket (the caller's hint, then the block edges read), as a
// learned index does over the near-uniform keys the flow makes, for at
// most ISEARCH_GUESSES rounds.  The guess only places the block, so the
// answer is exact whatever the keys.  pk must be 16-byte aligned and
// readable up to the multiple of 4 above n (the wrappers check both); no
// read reaches past that.  A NaN q, below nothing, gives 0.
struct Isearch {
  int l, h;
  float kl, kh;
  int guesses;
  int b;  // the block's first row
  float4 v[ISEARCH_ROWS / 4];

  __device__ __forceinline__ bool open() const { return l < h; }

  // the round's block, all of its loads issued before any is used
  __device__ __forceinline__ void load(const float* pk, float q) {
    int g = (l + h) >> 1;
    const float span = kh - kl;
    if (h - l <= ISEARCH_NARROW && guesses < ISEARCH_GUESSES && kl < q &&
        q < kh && span < INFINITY) {
      g = l + __float2int_rz((q - kl) / span * static_cast<float>(h - l));
      ++guesses;
    }
    // the block starts at a 32-byte boundary at most half a block below
    // the guess, within reach of [l, h)
    const int lim = h - ISEARCH_ROWS > l ? h - ISEARCH_ROWS : l;
    int s = g - ISEARCH_ROWS / 2;
    s = s < l ? l : (s > lim ? lim : s);
    b = s & ~7;
#pragma unroll
    for (int c = 0; c < ISEARCH_ROWS / 4; ++c) {
      const int r = b + 4 * c;
      if (r < h && r + 3 >= l) {
        v[c] = __ldg(reinterpret_cast<const float4*>(pk + r));
      }
    }
  }

  __device__ __forceinline__ void step(float q) {
    const int f = b > l ? b : l;
    const int e = b + ISEARCH_ROWS < h ? b + ISEARCH_ROWS : h;
    int below = 0;
    float kf = 0.f, ke = 0.f;
#pragma unroll
    for (int r = 0; r < ISEARCH_ROWS; ++r) {
      const float4 w = v[r / 4];
      const float x = r % 4 == 0 ? w.x : r % 4 == 1 ? w.y : r % 4 == 2 ? w.z
                                                                       : w.w;
      const int j = b + r;
      below += (j >= f && j < e && x < q);
      if (j == f) kf = x;
      if (j == e - 1) ke = x;
    }
    if (below == 0) {
      h = f;
      kh = kf;
    } else if (below == e - f) {
      l = e;
      kl = ke;
    } else {
      l = h = f + below;
    }
  }

  // kl: the key of row 0; kh: a key at or above every live row.  A q at
  // or below kl, or above kh, needs no read.
  __device__ __forceinline__ static Isearch start(int n, float q, float kl,
                                                  float kh) {
    Isearch s{0, n, kl, kh, 0};
    if (q <= kl) {
      s.h = 0;
    } else if (q > kh) {
      s.l = n;
    }
    return s;
  }

  __device__ __forceinline__ static int search(const float* pk, int n,
                                               float q, float kl, float kh) {
    Isearch s = start(n, q, kl, kh);
    while (s.open()) {
      s.load(pk, q);
      s.step(q);
    }
    return s.l;
  }
};

// Two searches for one q stepping together, round for round: the rounds
// cost the longer search's, not their sum.  Each is steered by its own
// first and last live keys.
__device__ __forceinline__ void isearch2(const float* pa, int na,
                                         const float* pb, int nb, float q,
                                         int& la, int& lb) {
  Isearch a = Isearch::start(na, q, na > 0 ? __ldg(pa) : 0.f,
                             na > 0 ? __ldg(pa + na - 1) : 0.f);
  Isearch b = Isearch::start(nb, q, nb > 0 ? __ldg(pb) : 0.f,
                             nb > 0 ? __ldg(pb + nb - 1) : 0.f);
  while (a.open() || b.open()) {
    const bool wa = a.open(), wb = b.open();
    if (wa) a.load(pa, q);
    if (wb) b.load(pb, q);
    if (wa) a.step(q);
    if (wb) b.step(q);
  }
  la = a.l;
  lb = b.l;
}

// The index of the newest row matching (qhi, qlo) in the window
// [l - W, l + 3W) around a lower bound l, clipped to the live rows
// [0, n); -1 if none, else its payload in `pay`.  Two rounds: hi over the
// whole window, four rows per 16-byte load (hi's base is 16-byte aligned
// and its capacity a multiple of 4, which the wrappers check), then lo
// and pv only where hi matched, newest first.  A window wider than
// WINDOW_VEC_MAX rows a side is read row by row.
__device__ __forceinline__ int window_newest(const int* hi, const int* lo,
                                             const int* pv, int n,
                                             int window, int l, int qhi,
                                             int qlo, int& pay) {
  const int j0 = max(l - window, 0);
  const int j1 = min(l + 3 * window, n);
  if (j0 >= j1) return -1;
  if (window > WINDOW_VEC_MAX) {
    int last = -1;
    for (int j = j0; j < j1; ++j) {
      if (__ldg(hi + j) == qhi && __ldg(lo + j) == qlo) last = j;
    }
    if (last >= 0) pay = __ldg(pv + last);
    return last;
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
    if (o == qlo) {
      pay = v;
      return base + b;
    }
    m &= ~(1ull << b);
  }
  return -1;
}

// Payload of the newest row matching (qhi, qlo) in the window around l
// (`window_newest`); -1 if none (a matched TOMBSTONE passes through).
__device__ __forceinline__ int window_pv(const int* hi, const int* lo,
                                         const int* pv, int n, int window,
                                         int l, int qhi, int qlo) {
  int pay = -1;
  return window_newest(hi, lo, pv, n, window, l, qhi, qlo, pay) >= 0 ? pay
                                                                     : -1;
}
