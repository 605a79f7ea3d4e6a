// One-token GQA decode attention: split-S over staged K/V tiles.
//
// Replaces `flash_decode_pallas` (src/repro/kernels/flash_decode.py), behind
// `ops.flash_decode`.  q [B, H, D] f32 (pre-scaled by 1/sqrt(D)); k and v
// [B, S, KH, D] in f32, bf16 or f16, widened to f32 exactly in the kernel
// (the TPU wrapper casts them first; the values are the same); kv_len
// i32[B].  Per (b, h), with kv head h / (H / KH) and positions
// s < kv_len[b]:
//
//   o = sum_s p_s v_s / max(sum_s p_s, 1e-20),  p_s = exp(q.k_s - max q.k)
//
// as the TPU wrapper normalises, so a row with kv_len 0 gives 0.
//
// Bound on the card: bytes -- the K and V rows below kv_len, read once,
// plus q and o.  The f32 arithmetic (about 4 flops per q head per K/V
// element) is far below the CUDA cores' rate, so the design is about
// moving each K/V byte once and keeping the loads in flight:
//
// - Grid (split, kv head x head group, b).  One block serves up to GMAX q
//   heads of one kv head, so a K/V row leaves device memory once for its
//   whole GQA group.  The wrapper's plan cuts S into splits of
//   `split_len` positions (a multiple of TILE) so that the grid fills the
//   card at B 1 as at B 16, in whole waves of the blocks that fit at once
//   (`flash_decode_resident`); a split at or past kv_len writes the empty
//   partial (m NEG_INF, l 0, acc 0) and returns.
// - Inside a block each warp runs its own pipeline, with no block barrier
//   until the end: warp w takes the split's tiles of TILE positions w,
//   w + nw, ... through a ring of NSTG stages of its own in shared memory,
//   filled with cp.async (16 B where rows and pointers allow), so its next
//   tile's loads are in flight while it computes the current one.
// - One softmax step per tile and head: a score pass with a lane per
//   position and half of its row (K rows padded to an odd number of 16 B
//   chunks, so a quarter-warp's reads hit eight different bank groups), q
//   from shared memory; the tile's max and sum by shuffles; alpha =
//   exp(m - m') (0 while m is still NEG_INF, the TPU kernel's guard), p =
//   exp(s - m') (0 where masked); then the PV pass, lanes over 16 B column
//   chunks of V and groups of positions, p broadcast from shared memory.
// - At the end the block merges its warps' (m, l, acc) and writes its
//   unnormalised partial per head; a second small kernel merges a row's
//   splits: o = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-20), w_i = 0 where
//   m_i is NEG_INF, else exp(m_i - max m).  Both launches are one call of
//   the C entry point.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define MAX_D 256
#define TILE 16                // positions per warp tile (the plan's tile)
#define NSTG 2                 // stages of each warp's ring
#define MAX_WARPS 4            // warps per block
#define GMAX 8                 // q heads per block
#define RING_BUDGET (96 * 1024)  // bytes of K/V rings per block

struct DecodeArgs {
  const float* q;     // [B, H, D]
  const void* k;      // [B, S, KH, D]
  const void* v;      // [B, S, KH, D]
  const int* kv_len;  // [B]
  float* o;           // [B, H, D]
  float* part_m;      // [B, H, splits]
  float* part_l;      // [B, H, splits]
  float* part_acc;    // [B, H, splits, D]
  int B;
  int H;
  int KH;
  int S;
  int D;
  int dtype;          // 0 f32, 1 bf16, 2 f16
  int splits;
  int split_len;      // a multiple of TILE
};

// 16 bytes of shared memory widened exactly to f32
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static void widen(const unsigned char* p,
                                               float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void widen(const unsigned char* p,
                                               float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Chunk<__half> {
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void widen(const unsigned char* p,
                                               float* out) {
    const __half2* x = reinterpret_cast<const __half2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(x[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src, int cpb) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (cpb) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src));
      break;
    default:  // 2-byte rows with an odd D: no cp.async of that size
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared-memory layout, in bytes from the start of the dynamic buffer
struct Layout {
  int rb;      // bytes of one K/V row (D elements)
  int nch;     // 16 B chunks per row
  int rsk;     // K row stride: an odd number of chunks (conflict-free score)
  int rsv;     // V row stride
  int stage;   // one warp tile of K then V
  int nw;      // warps per block
  int dp;      // f32 elements per q row (nch * VEC)
  int q;       // offset of q [GMAX][dp]
  int pw;      // offset of p [MAX_WARPS][GMAX][TILE]
  int ml;      // offset of (m, l) [MAX_WARPS][GMAX][2]
  int total;
  __host__ __device__ Layout(int D, int elem, int vec) {
    rb = D * elem;
    nch = (rb + 15) / 16;
    rsk = 16 * (nch | 1);
    rsv = 16 * nch;
    stage = TILE * (rsk + rsv);
    nw = RING_BUDGET / (NSTG * stage);
    nw = nw < 1 ? 1 : (nw > MAX_WARPS ? MAX_WARPS : nw);
    dp = nch * vec;
    q = nw * NSTG * stage;
    pw = q + 4 * GMAX * dp;
    ml = pw + 4 * MAX_WARPS * GMAX * TILE;
    total = ml + 4 * MAX_WARPS * GMAX * 2;
  }
};

// GH q heads per block, all computed (q rows past the group are zero and
// their results never stored): no branch splits the heads' FMA chains
template <typename T, int GH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    decode_split_kernel(const DecodeArgs a, int cpb) {
  constexpr int VEC = Chunk<T>::VEC;
  constexpr int CPL = 8 / VEC;  // V chunks per PV lane: 8 columns a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(a.D, sizeof(T), VEC);
  float* s_q = reinterpret_cast<float*>(smem + lay.q);
  float* s_pw = reinterpret_cast<float*>(smem + lay.pw);
  float* s_ml = reinterpret_cast<float*>(smem + lay.ml);

  const int G = a.H / a.KH;
  const int hgroups = (G + GH - 1) / GH;
  const int split = blockIdx.x;
  const int kh = blockIdx.y / hgroups;
  const int hg = blockIdx.y % hgroups;
  const int b = blockIdx.z;
  const int h0 = kh * G + hg * GH;
  const int gc = min(GH, G - hg * GH);
  const int D = a.D;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  int len = a.kv_len[b];
  len = len < 0 ? 0 : (len > a.S ? a.S : len);
  const int s0 = split * a.split_len;
  const int s1 = min(s0 + a.split_len, len);
  // partial of head h0 + g: index pbase + g * splits
  const size_t pbase = (static_cast<size_t>(b) * a.H + h0) * a.splits + split;
  const size_t ps = a.splits;
  if (s1 <= s0) {
    for (int i = tid; i < gc * D; i += nthr) {
      a.part_acc[(pbase + (i / D) * ps) * D + i % D] = 0.f;
    }
    if (tid < gc) {
      a.part_m[pbase + tid * ps] = NEG_INF;
      a.part_l[pbase + tid * ps] = 0.f;
    }
    return;
  }

  for (int i = tid; i < GH * lay.dp; i += nthr) {
    const int g = i / lay.dp, j = i % lay.dp;
    s_q[i] = (g < gc && j < D)
                 ? a.q[(static_cast<size_t>(b) * a.H + h0 + g) * D + j]
                 : 0.f;
  }
  if (lay.rb != 16 * lay.nch) {
    // rows shorter than their 16 B chunks: the tails stay zero, so the
    // score pass's last chunk multiplies zeros by q's zero padding
    for (int i = tid * 16; i < lay.q; i += nthr * 16) {
      *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int w = tid >> 5;
  unsigned char* ring = smem + w * NSTG * lay.stage;
  float* pw = s_pw + w * GMAX * TILE;
  const size_t row_stride = static_cast<size_t>(a.KH) * lay.rb;
  const size_t base = (static_cast<size_t>(b) * a.S * a.KH + kh) *
                      static_cast<size_t>(lay.rb);
  const unsigned char* gk = static_cast<const unsigned char*>(a.k) + base;
  const unsigned char* gv = static_cast<const unsigned char*>(a.v) + base;
  // copy units of cpb bytes: a lane takes unit cu of rows cr, cr + rpi, ..
  // (or, past 32 units a row, units cu, cu + 32, .. of every row)
  const int units = lay.rb / cpb;
  const int rpi = units < 32 ? 32 / units : 1;
  const int cu = units < 32 ? lane % units : lane;
  const int cr = units < 32 ? lane / units : 0;
  const int ntiles = (s1 - s0 + TILE - 1) / TILE;
  const int nk = w < ntiles ? (ntiles - w + lay.nw - 1) / lay.nw : 0;

  // warp w takes the split's tiles w, w + nw, ...; its k-th goes to
  // stage k % NSTG of its own ring
  auto issue = [&](int k) {
    const int p0 = s0 + (w + k * lay.nw) * TILE;
    const int nv = min(TILE, s1 - p0);
    unsigned char* dk = ring + (k % NSTG) * lay.stage;
    unsigned char* dv = dk + TILE * lay.rsk;
    if (cr >= rpi) return;
    for (int r = cr; r < nv; r += rpi) {
      for (int u = cu * cpb; u < lay.rb; u += 32 * cpb) {
        const size_t off = static_cast<size_t>(p0 + r) * row_stride + u;
        copy_unit(dk + r * lay.rsk + u, gk + off, cpb);
        copy_unit(dv + r * lay.rsv + u, gv + off, cpb);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < NSTG - 1; ++k) {
    if (k < nk) issue(k);
    cp_commit();
  }

  const int pos = lane & (TILE - 1);    // score pass: position of the tile
  const int half = lane / TILE;         //   and every other column chunk
  const int ncu = (lay.nch + CPL - 1) / CPL;
  const int jc = lane % ncu;          // PV pass: chunks jc, jc + ncu, ..
  const int ph = lane / ncu;          //   of positions ph, ph + nph, ..
  const int nph = 32 / ncu;
  float m_run[GH], l_run[GH], acc[GH][8];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int k = 0; k < nk; ++k) {
    cp_wait<NSTG - 2>();
    __syncwarp();  // tile k landed for every lane; tile k - 1 is done
    if (k + NSTG - 1 < nk) issue(k + NSTG - 1);
    cp_commit();
    const unsigned char* K = ring + (k % NSTG) * lay.stage;
    const unsigned char* V = K + TILE * lay.rsk;
    const int nv = min(TILE, s1 - (s0 + (w + k * lay.nw) * TILE));

    // score pass: half of a row's chunks per lane, then the other half's
    float sc[GH];
#pragma unroll
    for (int g = 0; g < GH; ++g) sc[g] = 0.f;
    for (int c = half; c < lay.nch; c += 2) {
      float kf[VEC];
      Chunk<T>::widen(K + pos * lay.rsk + c * 16, kf);
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        const float4* qq =
            reinterpret_cast<const float4*>(s_q + g * lay.dp + c * VEC);
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 qv = qq[e4];
          sc[g] = fmaf(qv.x, kf[4 * e4], sc[g]);
          sc[g] = fmaf(qv.y, kf[4 * e4 + 1], sc[g]);
          sc[g] = fmaf(qv.z, kf[4 * e4 + 2], sc[g]);
          sc[g] = fmaf(qv.w, kf[4 * e4 + 3], sc[g]);
        }
      }
    }
    // one softmax step per head per tile (both halves hold every score)
    const bool valid = pos < nv;
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float full = sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], TILE);
      const float x = valid ? full : NEG_INF;
      float mt = x;
#pragma unroll
      for (int off = TILE / 2; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      const float m_new = fmaxf(m_run[g], mt);
      const float alpha = m_run[g] == NEG_INF ? 0.f : expf(m_run[g] - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = TILE / 2; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      l_run[g] = l_run[g] * alpha + psum;
      m_run[g] = m_new;
      if (half == 0) pw[g * TILE + pos] = p;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
    __syncwarp();

    // PV pass: p broadcast from shared memory
    if (ph < nph) {
      for (int r = ph; r < nv; r += nph) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          const int c = jc + cc * ncu;
          if (c < lay.nch) {
            float vf[VEC];
            Chunk<T>::widen(V + r * lay.rsv + c * 16, vf);
#pragma unroll
            for (int g = 0; g < GH; ++g) {
              const float p = pw[g * TILE + r];
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                acc[g][cc * VEC + e] = fmaf(p, vf[e], acc[g][cc * VEC + e]);
              }
            }
          }
        }
      }
    }
  }
  cp_wait<0>();

  // merge the warps' (m, l, acc), one head at a time, through the rings
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      s_ml[(w * GMAX + g) * 2] = m_run[g];
      s_ml[(w * GMAX + g) * 2 + 1] = l_run[g];
    }
  }
  float* red = reinterpret_cast<float*>(smem);  // [nw * nph][D]
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    if (g < gc) {
      __syncthreads();
      float mx = NEG_INF;
      for (int i = 0; i < lay.nw; ++i) mx = fmaxf(mx, s_ml[(i * GMAX + g) * 2]);
      const float mw = s_ml[(w * GMAX + g) * 2];
      const float f = mw == NEG_INF ? 0.f : expf(mw - mx);
      if (ph < nph) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int j = (jc + cc * ncu) * VEC + e;
            if (j < D) red[(w * nph + ph) * D + j] = acc[g][cc * VEC + e] * f;
          }
        }
      }
      __syncthreads();
      const size_t at = pbase + g * ps;
      for (int j = tid; j < D; j += nthr) {
        float s = 0.f;
        for (int r = 0; r < lay.nw * nph; ++r) s += red[r * D + j];
        a.part_acc[at * D + j] = s;
      }
      if (tid == 0) {
        float l = 0.f;
        for (int i = 0; i < lay.nw; ++i) {
          const float mi = s_ml[(i * GMAX + g) * 2];
          if (mi != NEG_INF) l += s_ml[(i * GMAX + g) * 2 + 1] * expf(mi - mx);
        }
        a.part_m[at] = mx;
        a.part_l[at] = l;
      }
    }
  }
}

__global__ void __launch_bounds__(256)
    decode_combine_kernel(const DecodeArgs a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row = (static_cast<size_t>(b) * a.H + h) * a.splits;
  const float* m = a.part_m + row;
  const float* l = a.part_l + row;
  float mx = NEG_INF;
  for (int i = 0; i < a.splits; ++i) mx = fmaxf(mx, m[i]);
  float den = 0.f;
  for (int i = 0; i < a.splits; ++i) {
    den += m[i] == NEG_INF ? 0.f : l[i] * expf(m[i] - mx);
  }
  den = fmaxf(den, 1e-20f);
  float* orow = a.o + (static_cast<size_t>(b) * a.H + h) * a.D;
  for (int j = threadIdx.x; j < a.D; j += blockDim.x) {
    float o = 0.f;
    for (int i = 0; i < a.splits; ++i) {
      if (m[i] != NEG_INF) o += expf(m[i] - mx) * a.part_acc[(row + i) * a.D + j];
    }
    orow[j] = o / den;
  }
}

// raises the kernel's dynamic shared-memory limit once for its layout
template <typename T, int GH>
static int prepare(const Layout& lay) {
  static int raised = 0;
  if (lay.total > 48 * 1024 && raised < lay.total) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, GH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = lay.total;
  }
  return 0;
}

template <typename T, int GH>
static int launch_heads(const DecodeArgs& a, int cpb, cudaStream_t stream) {
  const Layout lay(a.D, sizeof(T), Chunk<T>::VEC);
  const int err = prepare<T, GH>(lay);
  if (err) return err;
  const int hgroups = (a.H / a.KH + GH - 1) / GH;
  const dim3 grid(a.splits, a.KH * hgroups, a.B);
  decode_split_kernel<T, GH><<<grid, lay.nw * 32, lay.total, stream>>>(a, cpb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GH>
static int resident_heads(int D, int* blocks) {
  const Layout lay(D, sizeof(T), Chunk<T>::VEC);
  const int err = prepare<T, GH>(lay);
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_split_kernel<T, GH>, lay.nw * 32, lay.total));
}

template <typename T>
static int resident(int D, int G, int* blocks) {
  switch (G < GMAX ? G : GMAX) {
    case 1: return resident_heads<T, 1>(D, blocks);
    case 2: return resident_heads<T, 2>(D, blocks);
    case 3: return resident_heads<T, 3>(D, blocks);
    case 4: return resident_heads<T, 4>(D, blocks);
    case 5: return resident_heads<T, 5>(D, blocks);
    case 6: return resident_heads<T, 6>(D, blocks);
    case 7: return resident_heads<T, 7>(D, blocks);
    default: return resident_heads<T, GMAX>(D, blocks);
  }
}

template <typename T>
static int launch(const DecodeArgs& a, cudaStream_t stream) {
  // the widest cp.async unit that the rows and both base pointers allow
  const uintptr_t al = static_cast<uintptr_t>(a.D * sizeof(T)) |
                       reinterpret_cast<uintptr_t>(a.k) |
                       reinterpret_cast<uintptr_t>(a.v);
  const int cpb = (al & 15) == 0 ? 16 : (al & 7) == 0 ? 8 : (al & 3) == 0 ? 4 : 2;
  const int G = a.H / a.KH;
  if (a.KH * ((G + GMAX - 1) / GMAX) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err;
  switch (G < GMAX ? G : GMAX) {
    case 1: err = launch_heads<T, 1>(a, cpb, stream); break;
    case 2: err = launch_heads<T, 2>(a, cpb, stream); break;
    case 3: err = launch_heads<T, 3>(a, cpb, stream); break;
    case 4: err = launch_heads<T, 4>(a, cpb, stream); break;
    case 5: err = launch_heads<T, 5>(a, cpb, stream); break;
    case 6: err = launch_heads<T, 6>(a, cpb, stream); break;
    case 7: err = launch_heads<T, 7>(a, cpb, stream); break;
    default: err = launch_heads<T, GMAX>(a, cpb, stream);
  }
  if (err) return err;
  decode_combine_kernel<<<dim3(a.H, a.B), 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// blocks of the split kernel that fit on one SM at once, for the plan
extern "C" int flash_decode_resident(int dtype, int D, int G, int* blocks) {
  if (D <= 0 || D > MAX_D || G <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0: return resident<float>(D, G, blocks);
    case 1: return resident<__nv_bfloat16>(D, G, blocks);
    case 2: return resident<__half>(D, G, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_decode_launch(const DecodeArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0) return 0;
  if (a->KH <= 0 || a->H % a->KH != 0 || a->D <= 0 || a->D > MAX_D ||
      a->S < 0 || a->B > 65535 || a->splits <= 0 || a->split_len <= 0 ||
      a->split_len % TILE != 0 ||
      static_cast<long long>(a->splits) * a->split_len < a->S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return launch<float>(*a, s);
    case 1: return launch<__nv_bfloat16>(*a, s);
    case 2: return launch<__half>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
