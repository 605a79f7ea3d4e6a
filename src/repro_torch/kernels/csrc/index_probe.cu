// One model-node probe for a query batch, one thread per query.
//
// Replaces `index_probe_pallas` (src/repro/kernels/index_probe.py), the
// per-level probe of AFLI's lookup behind `ops.index_probe`.  Per query:
//
//  * slot = clamp(rint(slope*q + intercept), 0, S-1), with the multiply
//    and the add rounded separately (__fmul_rn/__fadd_rn), as the fused
//    kernel places keys and as the numpy builder rounds.  (XLA on the CPU
//    contracts this arithmetic into an FMA, so the reference can land one
//    slot away when the sum sits on a rint half-way boundary.)  The
//    f32 -> i32 conversion saturates, as the card's cvt does;
//  * the entry code and child id at the slot;
//  * the payload where the entry is DATA and its identity halves (int32
//    bit views of the u32 pools) match the query's, else -1.
//
// Bound on the card: bytes.  Each query reads its key and identity (12
// bytes) and writes three i32 (12 bytes); the node's entry arrays are
// gathered at one slot a query, a sector each, reused across queries
// that land near each other.  A simple design: one query per thread,
// gathers through the read-only path (__ldg), the identity and payload
// read only when the entry is DATA and the previous half matched.
#include <cstdint>

#include <cuda_runtime.h>

#define ET_DATA 1

struct ProbeArgs {
  const float* qkey;
  const int* qhi;
  const int* qlo;
  const int* etype;
  const int* ehi;
  const int* elo;
  const int* epay;
  const int* echild;
  int* out_pay;
  int* out_code;
  int* out_child;
  float slope;
  float intercept;
  int B;
  int S;
};

__global__ void index_probe_kernel(const ProbeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  const float q = __ldg(a.qkey + i);
  int slot = __float2int_rz(rintf(__fadd_rn(__fmul_rn(a.slope, q),
                                            a.intercept)));
  slot = slot < 0 ? 0 : (slot > a.S - 1 ? a.S - 1 : slot);
  const int et = __ldg(a.etype + slot);
  int pay = -1;
  if (et == ET_DATA && __ldg(a.ehi + slot) == __ldg(a.qhi + i) &&
      __ldg(a.elo + slot) == __ldg(a.qlo + i)) {
    pay = __ldg(a.epay + slot);
  }
  a.out_pay[i] = pay;
  a.out_code[i] = et;
  a.out_child[i] = __ldg(a.echild + slot);
}

extern "C" int index_probe_launch(const ProbeArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  if (a->S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (a->B + threads - 1) / threads;
  index_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
}
