// Deliberately broken kernels for the contract checker's self-test
// (DESIGN.md §15).  Ports of the broken Pallas fixtures of
// src/repro/analysis/fixtures.py, each computing what the TPU kernel
// computes and each carrying its bug class on purpose, so that a change
// to the checks that stops catching a class fails the self-test:
//
//   clip_gather_kernel  (clip_gather_jaxpr, :38)  -> lint:clamp-gather
//   lane_cast_kernel    (lane_cast_jaxpr, :72)    -> lint:lane-cast
//   batch_loop_kernel   (batch_loop_jaxpr, :95)   -> lint:batch-loop
//   f64_upcast_kernel   (f64_upcast_jaxpr, :104)  -> lint:f64
//
// Bound: each moves a few hundred bytes a launch (batch_loop: 4,096 x 256
// compares), so a launch is its launch latency; nothing here is tuned.
// Plain C entry points, one per kernel: launch on the caller's stream,
// return cudaGetLastError().
#include <cuda_runtime.h>

#define THREADS 128

// out[i] = table[clamp(idx[i], 0, table_len - 1)].  The bug class: the
// index is clamped into the table, so an out-of-range index reads a
// wrong but plausible row instead of failing (a mode="clip" take).
__global__ void __launch_bounds__(THREADS)
    clip_gather_kernel(const int* __restrict__ idx,
                       const float* __restrict__ table,
                       float* __restrict__ out, int n, int table_len) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int j = min(max(idx[i], 0), table_len - 1);
  out[i] = table[j];
}

// out[i] = f32(hi[i]) * 2^32 + f32(lo[i]).  The bug class: the two u32
// identity lanes go through f32 (24 mantissa bits), so distinct
// identities collide.  The scale is a power of two, so the product is
// exact and a contracted FMA rounds as a multiply then an add does.
__global__ void __launch_bounds__(THREADS)
    lane_cast_kernel(const unsigned* __restrict__ hi,
                     const unsigned* __restrict__ lo,
                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = __uint2float_rn(hi[i]) * 4294967296.0f + __uint2float_rn(lo[i]);
}

// out[i] = #{j : pool[j] <= q[i]}.  The bug class: one thread loops over
// the whole batch, as the TPU's single program does, which runs in
// series what a grid would run in parallel.  Launched as one block of
// one thread.
__global__ void batch_loop_kernel(const float* __restrict__ q,
                                  const float* __restrict__ pool,
                                  int* __restrict__ out, int batch,
                                  int pool_len) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  for (int i = 0; i < batch; ++i) {
    const float qi = q[i];
    int c = 0;
    for (int j = 0; j < pool_len; ++j) c += pool[j] <= qi ? 1 : 0;
    out[i] = c;
  }
}

// out[i] = searchsorted_left(f32(linspace(0, 1, table_len)), pk[i]): the
// count of table entries below pk[i].  The bug class: the table is
// computed in double in the kernel (an f64 upcast on a f32 path).
__global__ void __launch_bounds__(THREADS)
    f64_upcast_kernel(const float* __restrict__ pk, int* __restrict__ out,
                      int n, int table_len) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float q = pk[i];
  int c = 0;
  for (int j = 0; j < table_len; ++j) {
    const double t = static_cast<double>(j) / static_cast<double>(table_len - 1);
    c += static_cast<float>(t) < q ? 1 : 0;
  }
  out[i] = c;
}

static inline int grid_for(int n) { return (n + THREADS - 1) / THREADS; }

extern "C" int clip_gather_launch(const int* idx, const float* table,
                                  float* out, int n, int table_len,
                                  void* stream) {
  if (n <= 0) return 0;
  clip_gather_kernel<<<grid_for(n), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(idx, table, out,
                                                            n, table_len);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lane_cast_launch(const unsigned* hi, const unsigned* lo,
                                float* out, int n, void* stream) {
  if (n <= 0) return 0;
  lane_cast_kernel<<<grid_for(n), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(hi, lo, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int batch_loop_launch(const float* q, const float* pool, int* out,
                                 int batch, int pool_len, void* stream) {
  if (batch <= 0) return 0;
  batch_loop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      q, pool, out, batch, pool_len);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int f64_upcast_launch(const float* pk, int* out, int n,
                                 int table_len, void* stream) {
  if (n <= 0) return 0;
  f64_upcast_kernel<<<grid_for(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(pk, out, n,
                                                           table_len);
  return static_cast<int>(cudaGetLastError());
}
