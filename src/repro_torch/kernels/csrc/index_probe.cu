// One model-node probe for a query batch, one query a thread.
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
// gathered at one slot a query.  Only the slot depends on the key, and
// the slot is clamped into the node, so every entry read is in bounds.
// The gathers are scattered 32-byte sectors, and their count, more than
// the number of dependent rounds, sets the pace: on the H100, reading
// all five entry arrays at every slot in one round, and four queries a
// thread with 16-byte loads and stores, measured no faster than this.
// So the kernel reads the code and the child at the slot, then, for a
// DATA entry only, its hi, lo and payload together (the payload
// speculatively): the sectors the probe needs (no more than a
// short-circuit chain reads when the queries are keys of the node) in
// three dependent rounds (key; code; hi, lo, payload).
#include <cuda_runtime.h>

#define ET_DATA 1
#define THREADS 256

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

__global__ void __launch_bounds__(THREADS)
index_probe_kernel(const ProbeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  const float q = __ldg(a.qkey + i);
  const int qhi = __ldg(a.qhi + i);
  const int qlo = __ldg(a.qlo + i);
  int slot = __float2int_rz(rintf(__fadd_rn(__fmul_rn(a.slope, q),
                                            a.intercept)));
  slot = slot < 0 ? 0 : (slot > a.S - 1 ? a.S - 1 : slot);
  const int code = __ldg(a.etype + slot);
  const int child = __ldg(a.echild + slot);
  int pay = -1;
  if (code == ET_DATA) {
    const int hi = __ldg(a.ehi + slot);
    const int lo = __ldg(a.elo + slot);
    const int pv = __ldg(a.epay + slot);
    if (hi == qhi && lo == qlo) pay = pv;
  }
  a.out_pay[i] = pay;
  a.out_code[i] = code;
  a.out_child[i] = child;
}

extern "C" int index_probe_launch(const ProbeArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  if (a->S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a->B + THREADS - 1) / THREADS;
  index_probe_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
