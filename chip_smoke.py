"""Drive repro_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero before the result lines):

1. device: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` and the contract checker's fixture
   kernels from ``src/repro_torch/analysis/csrc`` (one nvcc per source,
   in parallel).
1b. the contract checker (``repro_torch.analysis``, ~1 min): its four
   broken fixture kernels (B8 ``clip_gather``, B9 ``lane_cast``, B10
   ``batch_loop``, ``f64_upcast``) bit-equal to their plain versions
   (``batch_loop`` at 1, 33 and 4,096 queries); the self-test, whose
   launches are the fixtures' launch window (all six fixtures caught at
   a ``fixtures.cu`` or ``fixtures.py`` line); every contract over the
   real serving entries in process: host syncs per entry, the recorder
   against ``torch.cuda.set_sync_debug_mode``; each launch's grid, block,
   shared memory and registers; the shared-memory model against ptxas
   and against every profiled launch (the streamed kernel over a 2^25-row
   pool included); the PTX lints of every source.  Fails on a missed
   fixture, a blocking finding past ``analysis/allow.txt``, a model
   drift, or a recorder count below the debug mode's; then each fixture
   kernel timed cold and warm beside its plain version and bound.
2. ``longlat`` at 2^25 keys, half (2^24) bulk-loaded through
   ``NFL(NFLConfig(backend="flat"))`` with the default flow and training
   configs and AutoSwitch deciding (rerun with ``force_flow=True`` if it
   declines the flow, so the in-kernel NF serves):
   a. reads: the paper's read-only workload (zipf 0.99), 64 batches of
      65,536, plus one batch of unloaded keys;
   b. writes: the paper's ``write_heavy`` mix (20% reads, 80% inserts of
      unloaded keys), 64 batches of 65,536, below the fold trigger;
      every read checked, then every inserted key read back;
   c. updates and deletes: 65,536 loaded keys updated, 65,536 others
      deleted, then 1,024 more of each and 1,024 inserts, which stay in
      the delta; deleted keys must miss, updated keys read new payloads;
   d. range scans after YCSB workload E: 16 batches of 16,384 ranges,
      lengths uniform in 1-100, start ranks zipfian (0.99) over the live
      keys in positioning (z) order, each range ``[k_r, k_{r+L})``; every
      untruncated range equals the live payloads with z in
      ``[z(k_r), z(k_{r+L}))`` as a multiset;
   e. ``rebuild()`` folds everything; the reads, the deleted-key misses
      and one scan batch are checked again.
   The streamed rung (``pool_budget=0`` on the built index, switched
   with ``dataclasses.replace`` and back):
   s1. after 2a, the 64 read batches and the miss batch again through
       the streamed rung, every read checked; then each read batch
       through both rungs: payloads and z bit-equal; then the root node
       probed with each batch's z through ``ops.index_probe``: where the
       root entry is DATA, its payload is the fused rung's;
   s2. after 2c, the inserted, updated and deleted keys read back through
       the streamed rung;
   s3. after 2e, the router was rebuilt for the folded scan pool, and s1
       again with the deleted keys in place of the misses.
3. ``lognormal`` at 2^22 keys, 2^21 loaded, ``force_flow=False``: reads
   as in 2a; ``write_heavy`` batches until a fold starts and completes
   in-stream, the rung alternating per batch (even batches fused, odd
   batches streamed), every read checked, those served mid-fold
   included: the phase fails unless streamed reads were served while the
   fold ran and the streamed launches equal the odd batches' read calls
   (no fold verify streamed); 1,024 deletes; one scan batch.
4. sharded serving, with the single indexes' tensors freed: phase 2's
   longlat load (same keys, seed and loaded half) through
   ``NFL(NFLConfig(backend="flat", shards=4))``, the four shards on the
   one card, its flow trained one epoch (phase 2 trains the default
   three on the same keys), AutoSwitch deciding as in 2 (each shard's
   verdict, key count, depth and pool bytes printed, and the sharded
   verify's repaired keys):
   a. reads: 2a's 64 batches, each in its own launch window (one router
      ``nf_forward``, one ``fused_lookup`` per shard the batch reaches),
      every payload equal to the single index's in 2a, and its misses;
      the router's z bit-equal to the fused rung's on every batch; two
      batches through ``lookup_batch_async``, both in flight before
      either finishes; one batch split into its host steps and one under
      ``torch.profiler`` (do the shards' kernels overlap on the card?);
   b. busy-shard writes: batches of 65,536, 80% inserts of unloaded keys
      that route to shard 1 and 20% reads over all shards, until shard
      1's fold starts and completes in-stream; every read checked, those
      served mid-fold included; no other shard folds; every inserted key
      read back;
   c. 65,536 updates and 65,536 deletes across the shards;
   d. 2d's YCSB-E scans, then one batch of 1,024 ranges per boundary
      starting within 100 ranks below it and ending past it (at least
      3,072 must straddle and merge right);
   e. ``rebuild()``, then the reads, the deleted keys, the misses and one
      scan batch again.
5. kernels against their plain PyTorch versions on the card, at the
   main path's shapes: ``nf_forward`` on the bulk-load keys (and beside
   its dense PyTorch equivalent, both cold L2) and on the inserts of
   each ``write_heavy`` batch, bounded by the largest of its bytes, its
   FP32 issue and its SFU operations (counted per key in the SASS of the
   built kernel), its launches on the main path counted by batch size;
   ``fused_lookup`` and ``streamed_lookup`` on the read batches of the
   fresh index, flow on (longlat) and off (lognormal), each timed launch
   by launch over the same 64 distinct batches, each after an L2 flush
   (cold) or after an idle spin (warm), its host issue time apart,
   bounded by the distinct 32-byte sectors its reads touch (the
   streamed kernel by those of its first design's reads, the least the
   work needs, with its own count beside), their ratio printed; both on
   a batch taken while the run and delta hold data and tombstones;
   ``fused_lookup`` also at the fold verify's 4,096 keys (16 chunks in
   key order, no tiers) and, after 2b, both over the 52 read-back
   batches with the run and the delta populated;
   ``index_probe`` on longlat's root node with the read batches' z,
   timed and bounded the same way; ``fused_range_scan`` flow on and off
   on scan batches taken in that state (longlat's 16 batches timed the
   same way, bounded by the sectors of the endpoint searches, the pool
   spans and the probe windows, plus its inputs and output rows).
6. LM serving, falcon-mamba-7b at its full published config (64 layers,
   d_model 4096, vocab 65,024, bf16) with ``use_scan_kernel=True``,
   random weights on the card from the seed, after the index phases'
   tensors are freed: 16 requests (prompts of 256-2,048 tokens uniform
   over the vocabulary, 32 new tokens each) through the port's
   ``ContinuousBatcher`` with 8 slots until drained; every request must
   finish with 32 tokens, no logit may be NaN or inf, and ``mamba_scan``
   must launch 64 times per prefill.  Then a teacher-forced replay of 4
   requests at batch 1 (each of the batcher's tokens within 4 bf16 ulps
   of the replay's maximum logit), and the kernel path against the
   chunked path on one 2,048-token prompt: one ``mamba_block`` with
   layer 0's weights in f32 (within 2e-3), and the full model's bf16
   prefill logits (relative L2 under ``LM_LOGIT_REL_L2``, same argmax).
   One decode step of 8 slots runs under ``torch.profiler`` (its device
   operations and device time; informational, it fails nothing).
   ``ops.flash_decode`` is then driven at qwen3-14b's attention shape
   (40 q heads, 8 kv heads, head dim 128) over a 32,768-position bf16
   cache for 16 rows with ragged lengths (0, 1 and S among them).
7. the LM kernels against their plain versions: ``mamba_scan`` on the
   scan inputs of the first layers of the 2,048-token prompt and on a
   ragged L of 1,000, bounded by its bytes or its exponentials;
   ``flash_decode`` with the bf16 cache and an f32 one, timed beside
   ``scaled_dot_product_attention`` (the library yardstick only), and
   again at B 1 over the cache's row of length S, where the split plan
   matters most; each kernel's plan (scan chunks, decode splits) printed.
8. result lines: the kernel table as JSON, then the final JSON object
   ``{"ok": true, "device": {...}}``.

The launch counters are zeroed just before each driven step of phases
2, 3, 4 and 6 (and the fixtures' before the self-test of 1b) and read
just after; the kernels' launches in phases 1b's contract run, 5 and 7
and those that compute ground truth, replay or compare fall between
those windows and do not count.  Every window outside the streamed steps must
launch ``streamed_lookup`` 0 times (``pool_budget`` is None there).

Exits non-zero, printing no result, without a CUDA device or when the
repository's sources are missing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
SECTOR = 32                    # bytes per device-memory sector
BATCH = 65536
N_READ_BATCHES = 64
N_WRITE_BATCHES = 64           # longlat write_heavy batches
MAX_FOLD_BATCHES = 64          # lognormal: write batches allowed for a fold
TAIL = 1024                    # writes left in the delta before the scans
VERIFY_CHUNK = 4096            # FlatAFLIConfig.fold_step_keys
N_VERIFY_CHUNKS = 16
SCAN_BATCH = 16384
N_SCAN_BATCHES = 16
SCAN_CAP = 128
LONGLAT_KEYS = 1 << 25         # half bulk-loaded
N_SHARDS = 4                   # phase 4: key-space shards on one card
# phase 4 trains its flow on phase 2's keys again: one epoch, not the
# default three, keeps the smoke well inside its time limit on a slow host
SHARDED_FLOW_EPOCHS = 1
BUSY_SHARD = 1                 # the shard phase 4's inserts aim at
MAX_SHARD_WRITE_BATCHES = 96   # write batches allowed for its fold
STRADDLE = 1024                # phase 4: ranges straddling each boundary
LOGNORMAL_KEYS = 1 << 22
L2_FLUSH_BYTES = 512 << 20     # ten times the H100's 50 MB L2
SPIN_CYCLES = 400_000          # ~0.2 ms idle spin, longer than a host call
# exp2 results per SM per clock on compute capability 9.0 (the CUDA C++
# Programming Guide's table of arithmetic instruction throughput); one
# MUFU.EX2 per accurate expf
SFU_PER_SM_PER_CLOCK = 16
# FP32 lanes per SM per clock on compute capability 9.0 (the same table):
# one issue slot per rounded multiply or add, which must not fuse
FP32_PER_SM_PER_CLOCK = 128
LM_ARCH = "falcon-mamba-7b"
LM_REQUESTS = 16
LM_PROMPT = (256, 2048)        # prompt lengths, uniform, inclusive
LM_NEW = 32                    # new tokens per request
LM_SLOTS = 8
LM_REPLAYS = 4                 # requests replayed at batch 1
LM_CHECK_LEN = 2048            # kernel-vs-chunked prompt
LM_SCAN_LAYERS = 8             # layers whose scan inputs phase 7 times
LM_LOGIT_REL_L2 = 0.1          # kernel vs chunked bf16 prefill logits
SCAN_TOL = 1e-4                # mamba_scan vs plain (rtol and atol)
BRANCH_TOL = 2e-3              # f32 mamba_block, kernel vs chunked
FD_ATTN_ARCH = "qwen3-14b"     # flash_decode's attention shape
FD_BATCH, FD_SEQ = 16, 32768   # decode_32k's length; batch cut from 128
FD_F32_BATCH = 4
FD_STEPS = 4                   # ops.flash_decode calls in its window
# flash_decode vs plain, for every cache dtype: both widen k and v to f32
# exactly and compute in f32, so only the order of the sums differs (the
# JAX tests' 2e-2 for bf16 covers XLA rounding bf16 inputs, which neither
# side here does; outputs are a few hundredths in size, so 2e-2 would
# pass a kernel that returned zeros)
FD_TOL = 2e-5


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in f32 ulps (monotone integer image of the floats)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(s, s + c)`` over the (start, count) pairs."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    excl = np.cumsum(counts) - counts
    return np.repeat(np.asarray(starts, np.int64) - excl, counts) \
        + np.arange(total)


class Windows:
    """Launch counts of the main path: zeroed just before each driven
    step and read just after, summed per kernel."""

    def __init__(self, ops):
        self.ops = ops
        self.total = collections.Counter()
        self.lookup_sizes = collections.Counter()   # batch size -> launches
        self.nf_sizes = collections.Counter()

    def run(self, fn, streamed: bool = False):
        """Drive ``fn`` in a window; outside the streamed steps
        (``streamed`` False) the streamed kernel must not launch."""
        self.ops.reset_launch_counts()
        out = fn()
        counts = self.ops.launch_counts()
        counts["scan_truncated"] = self.ops.fused_range_scan.truncated
        self.total.update(counts)
        self.lookup_sizes.update(self.ops.fused_lookup_launch_sizes())
        self.nf_sizes.update(self.ops.nf_forward_launch_sizes())
        if not streamed and counts["streamed_lookup"]:
            fail(f"streamed_lookup launched {counts['streamed_lookup']} "
                 "times with pool_budget None")
        return out, counts


def size_buckets(sizes) -> dict:
    """Launches per batch size, gathered into power-of-two buckets
    ("<=65536": launches of 32,769 to 65,536 keys)."""
    out = collections.Counter()
    for size, n in sizes.items():
        out["<=" + str(1 << max(size - 1, 0).bit_length())] += n
    return dict(sorted(out.items(), key=lambda kv: int(kv[0][2:])))


def set_rung(nfl, budget) -> None:
    """Select the point-read rung of the built index: ``pool_budget=0``
    streams every live read, None never streams."""
    idx = nfl.index
    idx.cfg = dataclasses.replace(idx.cfg, pool_budget=budget)


class Truth:
    """Ground truth of the live keys: sorted keys and their payloads."""

    def __init__(self, keys, pv):
        order = np.argsort(keys, kind="stable")
        self.keys = np.asarray(keys, np.float64)[order]
        self.pv = np.asarray(pv, np.int64)[order]

    def _at(self, keys):
        j = np.minimum(np.searchsorted(self.keys, keys),
                       self.keys.shape[0] - 1)
        return j, self.keys[j] == keys

    def lookup(self, keys):
        j, hit = self._at(keys)
        return np.where(hit, self.pv[j], -1)

    def insert(self, keys, pv):
        keys = np.asarray(keys, np.float64)
        pv = np.asarray(pv, np.int64)
        j, hit = self._at(keys)
        self.pv[j[hit]] = pv[hit]
        # a key inserted twice in one call keeps its last payload
        new, last = np.unique(keys[~hit][::-1], return_index=True)
        self.__init__(np.concatenate([self.keys, new]),
                      np.concatenate([self.pv, pv[~hit][::-1][last]]))

    def update(self, keys, pv):
        j, hit = self._at(keys)
        if not hit.all():
            fail("update of an absent key in the ground truth")
        self.pv[j] = pv

    def delete(self, keys):
        j, hit = self._at(keys)
        keep = np.ones(self.keys.shape[0], bool)
        keep[j[hit]] = False
        self.keys, self.pv = self.keys[keep], self.pv[keep]


# ---------------------------------------------------------------- phases
def phase_build(build):
    t0 = time.perf_counter()
    info = build.build_all()
    secs = time.perf_counter() - t0
    for name, rec in info.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln]
        log(f"built {name}: {rec['path']} ({rec['seconds']:.1f} s); "
            + "; ".join(regs))
    log(f"kernel build wall time: {secs:.1f} s")
    return secs


# ------------------------------------------------- the contract checker
# fixture kernel -> the operations of its work on its inputs (its bytes
# are those of its inputs and output)
FIXTURE_OPS = {
    "clip_gather": lambda idx, table: 0,
    "lane_cast": lambda hi, lo: 0,
    "batch_loop": lambda q, pool: 2 * q.numel() * pool.numel(),
    "f64_upcast": lambda pk: 5 * 8 * pk.numel(),
}
FP32_FLOPS = 67e12             # H100 SXM, outside the tensor cores


def analysis_phase(flush_buf):
    """Phase 1b: the contract checker (``repro_torch.analysis``) on the
    card.  The fixture kernels against their plain versions bit for bit
    (``batch_loop`` at 1, 33 and 4,096 queries); the self-test in a launch
    window (every fixture caught at a ``fixtures.cu`` or ``fixtures.py``
    line, each kernel fixture launched); then every contract over the
    real entries in process (host syncs per entry, recorder against the
    sync debug mode; launch facts; the shared-memory model against ptxas
    and every profiled launch, the 2^25-row streamed pool included);
    then each fixture kernel timed cold and warm beside its plain
    version and its bound.  Fails on a missed fixture, a blocking
    finding, a model drift, a recorder count below the debug mode's, or
    a fixture kernel that differs from its plain version."""
    from repro_torch.analysis import fixtures as fx
    from repro_torch.analysis.__main__ import (DEFAULT_ALLOWLIST, run_all,
                                               run_fixture_selftest,
                                               _render_facts)
    from repro_torch.analysis.findings import Report, load_allowlist

    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    for b in (1, 33, 4096):
        q = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
        pool = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        got = fx.batch_loop(q.to(dev), pool.to(dev)).cpu()
        if not torch.equal(got, fx.batch_loop_plain(q, pool)):
            fail(f"batch_loop disagrees with its plain version at B {b}")
    errs = {}
    kernel_fixtures = {n: f for n, f in fx.FIXTURES.items() if f.call}
    for name, f in kernel_fixtures.items():
        call = f.call
        args = fx.fixture_inputs(name, dev)
        got = call(*args).cpu()
        want = call(*(a.cpu() for a in args))
        eq = bit_equal(got, want)
        errs[name] = float((got.double() - want.double()).abs().max())
        log(f"[analysis] {name}: kernel vs plain bit-equal {eq}")
        if not eq:
            fail(f"{name}: the fixture kernel disagrees with its plain "
                 "version")
    fx.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_fixture_selftest(dev)
    launches = fx.launch_counts()
    for line in buf.getvalue().splitlines():
        log(f"[analysis] self-test {line.strip()}")
    if rc != 0 or buf.getvalue().count("caught  fixture:") != len(
            fx.FIXTURES):
        fail("the contract checker missed a fixture")
    report = Report(allowlist=load_allowlist(DEFAULT_ALLOWLIST))
    t0 = time.perf_counter()
    facts = run_all(report, dev)
    for line in _render_facts(facts).splitlines():
        log(f"[analysis] {line.strip()}")
    drift = [f for f in report.findings if f.contract == "smem:model-drift"]
    under = [n for n, st in facts["syncs"].items()
             if st["syncs"] < st["debug_syncs"]]
    log(f"[analysis] python -m repro_torch.analysis in process: "
        f"{time.perf_counter() - t0:.1f} s; {len(report.blocking())} "
        f"blocking, {len(report.allowed())} allowlisted, "
        f"{len(report.advisory())} advisory; model drift {len(drift)}; "
        f"smem limit {facts['smem_limit']} B; entries where the recorder "
        f"counts below the debug mode: {under}")
    for f in report.advisory():
        log(f"[analysis] info [{f.contract}] {f.entry} @ {f.location}: "
            f"{f.message}")
    for f in report.blocking():
        log(f"[analysis] FAIL [{f.contract}] {f.entry} @ {f.location}: "
            f"{f.message}")
    if report.blocking() or drift or under:
        fail("the contract checker found blocking findings on the real "
             "entries")
    del facts
    gc.collect()
    torch.cuda.empty_cache()
    rows = {}
    for name, f in kernel_fixtures.items():
        call, row = f.call, f.call.__name__
        args = fx.fixture_inputs(name, dev)
        nbytes = sum(a.numel() * a.element_size()
                     for a in (*args, call(*args)))
        nops = FIXTURE_OPS[row](*args)
        fns = [lambda a=args: call(*a)] * 16
        cold, warm, host = timed_launches(fns, flush_buf)
        plain = getattr(fx, f"{row}_plain")
        plain_ms = time_ms(lambda: plain(*args), 5, 1)
        lib = None
        if row == "f64_upcast":
            table = fx.f64_table(8).to(dev)
            lib = time_ms(lambda: torch.searchsorted(table, args[0]), 5, 1)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / FP32_FLOPS * 1e3
        rows[row] = {
            "name": row, "route": "cuda",
            "source": "src/repro_torch/analysis/csrc/fixtures.cu",
            "replaces": f.replaces, "launches": launches[row],
            "max_abs_err": errs[name], "ms": statistics.median(cold),
            "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops > by_bytes else "bytes",
            "library_ms": lib, "ms_warm_l2": statistics.median(warm),
            "host_ms_per_call": host}
        log(f"[analysis] {row}: {rows[row]['ms']:.5f} ms cold, "
            f"{rows[row]['ms_warm_l2']:.5f} warm, host {host:.5f} ms/call; "
            f"plain {plain_ms:.4f} ms; library {lib}; bound "
            f"{rows[row]['bound_ms']:.2e} ms ({rows[row]['bound_by']}); "
            f"self-test launches {launches[row]}")
    return rows


def touched_sectors(pools, q, qhi, qlo, kw, tiers):
    """Distinct 32-byte sectors that the fused kernel's reads touch for
    one batch, replayed from ``csrc/fused_lookup.cu`` branch for branch
    (short-circuit reads included), and the mean traversal depth.  A
    sector that many queries read (the root's fields, the hot keys of a
    skewed batch) counts once.  Returns (sectors, reads, mean depth)."""
    from repro_torch.kernels.fused_lookup import (BUCKET, CHILD, DATA,
                                                  KIND_DENSE, _slot_index)
    reads = collections.defaultdict(list)      # pool -> element indices

    def read(pool, idx):
        reads[pool].append(idx.reshape(-1).to(torch.int64))

    dev = q.device
    n_entries = pools.ekey.shape[0]
    cap = pools.bhi.shape[1]
    node = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
    qq, hh, ll = q, qhi, qlo
    levels = 0
    for _ in range(kw["max_depth"]):
        if node.numel() == 0:
            break
        levels += node.numel()
        for f in ("node_kind", "node_offset", "node_size"):
            read(f, node)
        kind = pools.node_kind[node]
        off = pools.node_offset[node].to(torch.int64)
        size = pools.node_size[node].to(torch.int64)
        d = kind == KIND_DENSE
        # dense: the fixed-round search, then the window up to its
        # first full match
        qd, hd, ld = qq[d], hh[d], ll[d]
        l, h = off[d], off[d] + size[d]
        for _ in range(kw["dense_iters"]):
            mid = (l + h) // 2
            m = torch.clamp(mid, max=n_entries - 1)
            read("ekey", m)
            go = pools.ekey[m] < qd
            l, h = torch.where(go, mid + 1, l), torch.where(go, h, mid)
        last = off[d] + size[d] - 1
        e = torch.minimum(torch.maximum(l, off[d]), last)
        win = kw["dense_window"]
        j = torch.minimum(e[:, None] + torch.arange(win, device=dev),
                          last[:, None])
        km = pools.ekey[j] == qd[:, None]
        hm = km & (pools.ehi[j] == hd[:, None])
        full = hm & (pools.elo[j] == ld[:, None])
        found = full.any(dim=1)
        first = torch.where(found, torch.argmax(full.to(torch.int8), dim=1),
                            win - 1)
        seen = torch.arange(win, device=dev)[None, :] <= first[:, None]
        read("ekey", j[seen])
        read("ehi", j[seen & km])
        read("elo", j[seen & hm])
        read("epayload", j.gather(1, first[:, None])[:, 0][found])
        # model: slot, entry type, then the entry's own reads
        mo = ~d
        nm, qm, hm_, lm = node[mo], qq[mo], hh[mo], ll[mo]
        read("node_slope", nm)
        read("node_intercept", nm)
        slot = _slot_index(pools.node_slope[nm] * qm
                           + pools.node_intercept[nm])
        slot = torch.minimum(torch.clamp(slot, min=0), size[mo] - 1)
        e = off[mo] + slot
        read("etype", e)
        et = pools.etype[e]
        dt = et == DATA
        hit_hi = dt & (pools.ehi[e] == hm_)
        read("ehi", e[dt])
        read("elo", e[hit_hi])
        read("epayload", e[hit_hi & (pools.elo[e] == lm)])
        bk = et == BUCKET
        read("echild", e[bk])
        bid = torch.clamp(pools.echild[e[bk]], min=0).to(torch.int64)
        read("blen", bid)
        flat = bid[:, None] * cap + torch.arange(cap, device=dev)
        live = (torch.arange(cap, device=dev)[None, :]
                < pools.blen[bid][:, None])
        bh = live & (pools.bhi.reshape(-1)[flat] == hm_[bk][:, None])
        bl = bh & (pools.blo.reshape(-1)[flat] == lm[bk][:, None])
        read("bhi", flat[live])
        read("blo", flat[bh])
        read("bpayload", flat[bl])
        ch = et == CHILD
        read("echild", e[ch])
        node = pools.echild[e[ch]].to(torch.int64)
        qq, hh, ll = qm[ch], hm_[ch], lm[ch]
    tier_reads(tiers, q, qhi, qlo, read)
    return count_sectors(reads), sum(
        int(x.numel()) for v in reads.values() for x in v), \
        levels / q.shape[0]


def tier_reads(tiers, q, qhi, qlo, read) -> None:
    """The reads of the delta and run probes (``probe_tier`` of
    csrc/tier_device.cuh), which both point-read kernels end with."""
    if tiers is None:
        return
    t = tiers.pools
    zero = torch.zeros(1, dtype=torch.int64, device=q.device)
    for tag, iters, window in (("run", tiers.run_iters, tiers.run_window),
                               ("dl", tiers.delta_iters,
                                tiers.delta_window)):
        read(f"{tag}_len", zero)
        n = int(getattr(t, f"{tag}_len").item())
        if n <= 0:
            continue
        pk, hi, lo, pv = (getattr(t, f"{tag}_{f}")
                          for f in ("pk", "hi", "lo", "pv"))
        l = searched(pk, n, iters, q, lambda m, tag=tag:
                     read(f"{tag}_pk", m))
        probe_window(hi, lo, n, window, l, qhi, qlo,
                     lambda f, idx, tag=tag: read(f"{tag}_{f}", idx))


def streamed_sectors(sp, tiers, q, qhi, qlo):
    """Distinct 32-byte sectors that the streamed kernel's reads touch for
    one batch, replayed from ``csrc/streamed_lookup.cu``: the router's
    binary search and the walk down the bracket, each probed tile's
    11-round search and identity window (hi at every live position, lo
    where hi matched, pv at the match), then the tier probes.  Returns
    (sectors, mean tiles probed per query)."""
    from repro_torch.kernels.streamed_lookup import (STREAM_ALIGN,
                                                     TILE_ITERS, _wrap32,
                                                     ord_f32)
    reads = collections.defaultdict(list)

    def read(pool, idx):
        reads[pool].append(idx.reshape(-1).to(torch.int64))

    dev = q.device
    b = q.shape[0]
    pool, w = sp.pool, sp.window
    cap = pool.pk.shape[0]
    plen = int(pool.plen.item())
    read("slen", torch.zeros(1, dtype=torch.int64, device=dev))
    oz = ord_f32(q)
    lo_k = _wrap32(ord_f32(sp.router) - 2)
    hi_k = _wrap32(ord_f32(sp.router) + 2)
    l = torch.zeros(b, dtype=torch.int64, device=dev)
    h = torch.full((b,), (plen + STREAM_ALIGN - 1) // STREAM_ALIGN,
                   dtype=torch.int64, device=dev)
    while bool((l < h).any()):
        act = l < h
        mid = (l + h) // 2
        read("router", mid[act])
        go = act & (lo_k[torch.clamp(mid, max=lo_k.shape[0] - 1)] <= oz)
        l, h = torch.where(go, mid + 1, l), torch.where(act & ~go, mid, h)
    t = l - 1
    done = t < 0
    probed = 0
    cols = torch.arange(4 * w, device=dev)
    while not bool(done.all()):
        act = ~done
        read("router", (t + 1)[act])
        qs = act & (hi_k[torch.clamp(t + 1, 0)] >= oz)
        done = done | (act & ~qs)
        if bool(qs.any()):
            base = t[qs] * STREAM_ALIGN
            live = torch.clamp(plen - base, max=STREAM_ALIGN)
            last = base + torch.clamp(cap - base, max=STREAM_ALIGN) - 1
            zq, hq, lq = q[qs], qhi[qs], qlo[qs]
            tl_ = torch.zeros_like(base)
            th_ = live.clone()
            for _ in range(TILE_ITERS):
                mid = (tl_ + th_) // 2
                m = torch.minimum(base + mid, last)
                read("pk", m)
                go = pool.pk[m] < zq
                tl_ = torch.where(go, mid + 1, tl_)
                th_ = torch.where(go, th_, mid)
            j = (tl_ - w)[:, None] + cols
            inside = (j >= 0) & (j < live[:, None])
            g = torch.clamp(base[:, None] + j, 0, cap - 1)
            mh = inside & (pool.hi[g] == hq[:, None])
            ml = mh & (pool.lo[g] == lq[:, None])
            read("hi", g[inside])
            read("lo", g[mh])
            found = ml.any(dim=1)
            best = torch.max(torch.where(ml, g, -1), dim=1).values
            read("pv", best[found])
            hit = torch.zeros_like(done)
            hit[qs.nonzero()[:, 0][found]] = True
            done = done | hit
            probed += int(qs.sum())
        t = t - 1
        done = done | (t < 0)
    tier_reads(tiers, q, qhi, qlo, read)
    return count_sectors(reads), probed / b


ISEARCH_ROWS, ISEARCH_NARROW, ISEARCH_GUESSES = 8, 4096, 4  # tier_device.cuh


def isearch_reads(pk, base, n, q, kl, kh, read):
    """``Isearch`` of csrc/tier_device.cuh over the rows ``base + [0,
    n)`` (``base``, ``n`` and the steering keys ``kl``, ``kh`` per query
    or one for all), replayed: each round's aligned block at its guess,
    four rows a load, goes to ``read`` (the first row of each load).
    Returns the bounds (searchsorted-left)."""
    dev = q.device
    b = q.shape[0]
    base = torch.as_tensor(base, device=dev).to(torch.int64).expand(b)
    l = torch.zeros(b, dtype=torch.int64, device=dev)
    h = torch.as_tensor(n, device=dev).to(torch.int64).expand(b).clone()
    kl = torch.as_tensor(kl, dtype=torch.float32, device=dev).expand(b) \
        .clone()
    kh = torch.as_tensor(kh, dtype=torch.float32, device=dev).expand(b) \
        .clone()
    h = torch.where(q <= kl, 0, h)
    l = torch.where((q > kl) & (q > kh), h, l)
    rows = torch.arange(ISEARCH_ROWS, device=dev)
    loads = torch.arange(0, ISEARCH_ROWS, 4, device=dev)
    guesses = torch.zeros(b, dtype=torch.int64, device=dev)
    while True:
        o = l < h
        if not bool(o.any()):
            break
        lo_, ho, ql, qh, qo, bo = l[o], h[o], kl[o], kh[o], q[o], base[o]
        span = qh - ql
        guess = lo_ + ((qo - ql) / span * (ho - lo_).to(torch.float32)
                       ).nan_to_num(0.0).clamp(-2e9, 2e9).to(torch.int64)
        use = (ho - lo_ <= ISEARCH_NARROW) & (guesses[o] < ISEARCH_GUESSES) \
            & (ql < qo) & (qo < qh) & (span < float("inf"))
        guesses[o] += use.to(torch.int64)
        g = torch.where(use, guess, (lo_ + ho) // 2)
        st = torch.minimum(torch.maximum(g - ISEARCH_ROWS // 2, lo_),
                           torch.maximum(ho - ISEARCH_ROWS, lo_))
        bb = st & ~7
        r = bb[:, None] + loads
        read((bo[:, None] + r)[(r < ho[:, None]) & (r + 3 >= lo_[:, None])])
        f = torch.maximum(bb, lo_)
        e = torch.minimum(bb + ISEARCH_ROWS, ho)
        j = bb[:, None] + rows
        x = pk[(bo[:, None] + j).clamp(0, pk.shape[0] - 1)]
        below = ((j >= f[:, None]) & (j < e[:, None])
                 & (x < qo[:, None])).sum(1)
        none, every = below == 0, below == e - f
        kh[o] = torch.where(none, pk[bo + f], qh)
        kl[o] = torch.where(every, pk[(bo + e - 1).clamp(min=0)], ql)
        l[o] = torch.where(none, lo_, torch.where(every, e, f + below))
        h[o] = torch.where(none, f, torch.where(every, ho, f + below))
    return l


def window_reads(hi, lo, base, n, window, l, qhi, qlo, read):
    """``window_newest`` of csrc/tier_device.cuh around the bounds ``l``
    (rows ``base + [0, n)``), replayed: hi in aligned four-row loads over
    the window (row by row above WINDOW_VEC_MAX), then lo and pv at the hi
    matches, newest first, up to the first full match.  ``read(f, idx)``.
    Returns the matched rows (-1: none)."""
    dev = l.device
    base = torch.as_tensor(base, device=dev).to(torch.int64).expand(l.shape)
    n = torch.as_tensor(n, device=dev).to(torch.int64).expand(l.shape)
    j = (l - window)[:, None] + torch.arange(4 * window, device=dev)
    inside = (j >= 0) & (j < n[:, None])
    g = (base[:, None] + j).clamp(0, hi.shape[0] - 1)
    hm = inside & (hi[g] == qhi[:, None])
    full = hm & (lo[g] == qlo[:, None])
    newest = torch.max(torch.where(full, j, -1), dim=1).values
    if window > 8:
        read("hi", g[inside])
        read("lo", g[hm])
    else:
        first = torch.where(inside, j, 1 << 40).min(1).values
        last = torch.where(inside, j, -1).max(1).values
        k = (first >> 2)[:, None] + torch.arange(window + 1, device=dev)
        ok = (last >= 0)[:, None] & (k <= (last >> 2)[:, None])
        read("hi", (base[:, None] + 4 * k)[ok])
        seen = hm & (j >= newest[:, None])
        read("lo", g[seen])
        read("pv", g[seen])
    hit = newest >= 0
    if window > 8:
        read("pv", (base + newest)[hit])
    return torch.where(hit, base + newest, -1)


def streamed_kernel_sectors(sp, tiers, q, qhi, qlo):
    """Distinct 32-byte sectors that the redesigned streamed kernel's reads
    touch for one batch, replayed from ``csrc/streamed_lookup.cu``: the
    router's live entries staged once (16-byte copies), each probed
    tile's block search and identity window, then the tiers' block
    searches (after their first and last keys) and windows.  Returns the
    sector count."""
    from repro_torch.kernels.streamed_lookup import (STREAM_ALIGN, _wrap32,
                                                     ord_f32)
    reads = collections.defaultdict(list)

    def read(pool, idx):
        reads[pool].append(idx.reshape(-1).to(torch.int64))

    dev = q.device
    pool, w = sp.pool, sp.window
    cap = pool.pk.shape[0]
    plen = int(pool.plen.item())
    n_tiles = -(-plen // STREAM_ALIGN)
    read("slen", torch.zeros(1, dtype=torch.int64, device=dev))
    read("router", torch.arange(-(-(n_tiles + 1) // 4) * 4, device=dev))
    oz = ord_f32(q)
    lo_k = _wrap32(ord_f32(sp.router) - 2)
    hi_k = _wrap32(ord_f32(sp.router) + 2)
    t = torch.searchsorted(lo_k[:n_tiles].contiguous(), oz, right=True) - 1
    done = t < 0
    while not bool(done.all()):
        act = ~done & (hi_k[(t + 1).clamp(min=0)] >= oz)
        done = done | ~act
        if bool(act.any()):
            base = t[act] * STREAM_ALIGN
            live = torch.clamp(plen - base, max=STREAM_ALIGN)
            rows = torch.clamp(cap - base, max=STREAM_ALIGN)
            zq = q[act]
            lb = isearch_reads(pool.pk, base, live, zq, sp.router[t[act]],
                               sp.router[t[act] + 1],
                               lambda i: read("pk", i))
            lb = lb + ((lb == live) & (live == rows)).to(torch.int64)
            got = window_reads(pool.hi, pool.lo, base, live, w, lb,
                               qhi[act], qlo[act],
                               lambda f, i: read(f, i))
            hit = torch.zeros_like(done)
            hit[act.nonzero()[:, 0][got >= 0]] = True
            done = done | hit
        t = t - 1
        done = done | (t < 0)
    if tiers is not None:
        tp = tiers.pools
        for tag, window in (("dl", tiers.delta_window),
                            ("run", tiers.run_window)):
            n = int(getattr(tp, f"{tag}_len").item())
            read(f"{tag}_len", torch.zeros(1, dtype=torch.int64, device=dev))
            pk, hi, lo = (getattr(tp, f"{tag}_{f}") for f in ("pk", "hi",
                                                              "lo"))
            ends = torch.tensor([0, max(n - 1, 0)], device=dev)
            read(f"{tag}_pk", ends)
            lb = isearch_reads(pk, 0, n, q, pk[ends[0]], pk[ends[1]],
                               lambda i, tag=tag: read(f"{tag}_pk", i))
            window_reads(hi, lo, 0, n, window, lb, qhi, qlo,
                         lambda f, i, tag=tag: read(f"{tag}_{f}", i))
    return count_sectors(reads)


def probe_sectors(q, qhi, qlo, slope, intercept, entries, kernel=False):
    """Distinct sectors of one batch's entry gathers in ``index_probe``:
    the least the probe needs (etype and echild at each slot, ehi where
    the entry is DATA, elo where ehi matched, epay at a hit), or with
    ``kernel`` the reads of ``csrc/index_probe.cu``: etype and echild at
    each slot, then ehi, elo and epay together where the entry is DATA."""
    from repro_torch.kernels.fused_lookup import DATA, _slot_index
    etype, ehi, elo, epay, echild = entries
    sl = torch.tensor(np.float32(slope), device=q.device)
    ic = torch.tensor(np.float32(intercept), device=q.device)
    slot = torch.clamp(_slot_index(sl * q + ic), 0, etype.shape[0] - 1)
    d = etype[slot] == DATA
    if kernel:
        return count_sectors({"etype": [slot], "echild": [slot],
                              **{f: [slot[d]] for f in ("ehi", "elo",
                                                        "epay")}})
    mh = d & (ehi[slot] == qhi)
    ml = mh & (elo[slot] == qlo)
    return count_sectors({"etype": [slot], "echild": [slot],
                          "ehi": [slot[d]], "elo": [slot[mh]],
                          "epay": [slot[ml]]})


def searched(pk, n, iters, q, read):
    """``lower_bound`` of csrc/tier_device.cuh over the live length
    ``n`` (an int or a per-query tensor), replayed: each round's clamped
    index goes to ``read``.  Returns the bounds."""
    l = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    h = (torch.as_tensor(n, device=q.device).to(torch.int64)
         .expand(q.shape[0]).clone())
    for _ in range(iters):
        mid = (l + h) // 2
        m = torch.clamp(mid, max=pk.shape[0] - 1)
        read(m)
        go = pk[m] < q
        l, h = torch.where(go, mid + 1, l), torch.where(go, h, mid)
    return l


def probe_window(hi, lo, n, window, l, qhi, qlo, read):
    """The window reads of ``probe_tier`` around the bounds ``l``: hi at
    every live position, lo where hi matched, pv at the newest match.
    Returns which queries matched."""
    dev = l.device
    j = (l - window)[:, None] + torch.arange(4 * window, device=dev)
    inside = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, max(n - 1, 0))
    th = inside & (hi[jc] == qhi[:, None])
    tl = th & (lo[jc] == qlo[:, None])
    read("hi", j[inside])
    read("lo", j[th])
    hit = tl.any(dim=1)
    read("pv", torch.max(torch.where(tl, j, -1), dim=1).values[hit])
    return hit


def count_sectors(reads) -> int:
    """Distinct sectors over every pool's element reads (every pool is
    4-byte)."""
    per_sector = SECTOR // 4
    return sum(int(torch.unique(torch.cat(v) // per_sector).numel())
               for v in reads.values() if v)


def range_sectors(sp, tiers, zlo, zhi, scan_cap):
    """Sectors that one range batch must read, replayed from
    ``csrc/range_scan.cu``: each endpoint's search in the three pools,
    the span of candidates of each pool (at most ``scan_cap`` of each;
    all of it for an untruncated query), and the identity probes'
    windows into the newer tiers.  Returns (bound sectors, sectors of
    the probes' own binary searches, which the bound leaves out)."""
    reads = collections.defaultdict(list)
    probe_reads = collections.defaultdict(list)

    def reader(store, key):
        return lambda idx: store[key].append(idx.reshape(-1).to(torch.int64))

    pools = [("s", sp.pool.pk, sp.pool.hi, sp.pool.lo, sp.pool.pv,
              int(sp.pool.plen.item()), sp.iters, 1)]
    if tiers is not None:
        t = tiers.pools
        pools += [("r", t.run_pk, t.run_hi, t.run_lo, t.run_pv,
                   int(t.run_len.item()), tiers.run_iters, tiers.run_window),
                  ("d", t.dl_pk, t.dl_hi, t.dl_lo, t.dl_pv,
                   int(t.dl_len.item()), tiers.delta_iters,
                   tiers.delta_window)]
    spans = {}
    for tag, pk, hi, lo, pv, n, iters, _w in pools:
        a = searched(pk, n, iters, zlo, reader(reads, f"{tag}_pk"))
        b = searched(pk, n, iters, zhi, reader(reads, f"{tag}_pk"))
        cnt = torch.clamp(b - a, 0, scan_cap)
        idx = torch.from_numpy(ranges(a.cpu().numpy(), cnt.cpu().numpy())
                               ).to(zlo.device)
        for f in ("pk", "hi", "lo", "pv"):
            reads[f"{tag}_{f}"].append(idx)
        spans[tag] = idx
    for cand, newer in (("s", ("d", "r")), ("r", ("d",))):
        if cand not in spans or tiers is None:
            continue
        _, cpk, chi, clo, _, _, _, _ = next(p for p in pools if p[0] == cand)
        idx = spans[cand]
        m, qh, ql = cpk[idx], chi[idx], clo[idx]
        for tag in newer:
            _, pk, hi, lo, pv, n, iters, window = next(
                p for p in pools if p[0] == tag)
            if n <= 0 or not m.numel():
                continue
            l = searched(pk, n, iters, m, reader(probe_reads, f"{tag}_pk"))
            hit = probe_window(hi, lo, n, window, l, qh, ql,
                               lambda f, x, tag=tag:
                               reads[f"{tag}_{f}"].append(x.reshape(-1)))
            # the run is probed only after the delta missed
            m, qh, ql = m[~hit], qh[~hit], ql[~hit]
    return count_sectors(reads), count_sectors(probe_reads)


def launch_times_ms(fns, before) -> list:
    """Device time of each ``fn`` in turn: ``before()`` enqueues device
    work longer than a host call (an L2 flush or an idle spin), so each
    launch is queued before its start event fires and the events bracket
    the kernel alone."""
    ev = []
    for fn in fns:
        before()
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        fn()
        e_ev.record()
        ev.append((s_ev, e_ev))
    torch.cuda.synchronize()
    return [s_ev.elapsed_time(e_ev) for s_ev, e_ev in ev]


def host_ms_per_call(fns) -> float:
    """Host time to issue one call (the wrapper's Python and ctypes
    work), over the calls in turn, without waiting for the device."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for fn in fns:
        fn()
    host = (time.perf_counter() - t) / len(fns) * 1e3
    torch.cuda.synchronize()
    return host


def timed_launches(fns, flush_buf):
    for fn in fns[:4]:
        fn()
    cold = launch_times_ms(fns, flush_buf.zero_)
    warm = launch_times_ms(fns, lambda: torch.cuda._sleep(SPIN_CYCLES))
    host = host_ms_per_call(fns)
    return cold, warm, host


# ------------------------------------------------------ the main path
def bulkload_and_read(name, n_keys, force_flow, seed, m, win):
    """Phase 2a / 3a: bulk load, the read-only batches and one batch of
    unloaded keys, all checked."""
    t0 = time.perf_counter()
    keys = m.make_dataset(name, n_keys)
    wl = m.make_workload(keys, m.WorkloadConfig(
        mix="read_only", n_ops=N_READ_BATCHES * BATCH, batch_size=BATCH,
        zipf_s=0.99, seed=seed))
    unloaded = np.setdiff1d(keys, wl.load_keys, assume_unique=True)
    miss_keys = np.random.default_rng(seed).choice(unloaded, BATCH,
                                                   replace=False)
    log(f"[{name}] {keys.shape[0]} keys, {wl.load_keys.shape[0]} "
        f"bulk-loaded; data {time.perf_counter() - t0:.1f} s")

    def bulkload(force):
        torch.cuda.reset_peak_memory_stats()
        nfl = m.NFL(m.NFLConfig(backend="flat", force_flow=force))
        t = time.perf_counter()
        nfl.bulkload(wl.load_keys, wl.load_payloads)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    def drive():
        nfl, t_bulk = bulkload(force_flow)
        if force_flow is None and not nfl.use_flow:
            log(f"[{name}] AutoSwitch declined the flow (tails "
                f"{nfl.metrics['tail_conflict_original']:.0f} -> "
                f"{nfl.metrics['tail_conflict_transformed']:.0f}); "
                "rerunning with force_flow=True")
            m.ops.reset_launch_counts()
            nfl, t_bulk = bulkload(True)
        wrong = n_reads = 0
        pays = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _op, k, p in wl.batches:
            pays.append(nfl.lookup_batch(k))
            wrong += int((pays[-1] != p).sum())
            n_reads += k.shape[0]
        t_reads = time.perf_counter() - t
        wrong_miss = int((nfl.lookup_batch(miss_keys) != -1).sum())
        return nfl, t_bulk, wrong, n_reads, t_reads, wrong_miss, pays

    (nfl, t_bulk, wrong, n_reads, t_reads, wrong_miss, pays), counts = \
        win.run(drive)
    peak = torch.cuda.max_memory_allocated()
    mt = nfl.metrics
    stats = nfl.index.stats()
    log(f"[{name}] use_flow={nfl.use_flow} tail_conflict "
        f"original={mt['tail_conflict_original']:.0f} "
        f"transformed={mt['tail_conflict_transformed']:.0f} "
        f"shadowed={stats['n_shadowed']}")
    log(f"[{name}] bulkload {t_bulk:.2f} s = train "
        f"{mt['flow_train_s']:.2f} s ({mt['flow_n_steps']:.0f} steps) + "
        f"transform {mt['transform_s']:.2f} s + build "
        f"{mt['index_build_s']:.2f} s (+ AutoSwitch and packing)")
    log(f"[{name}] reads: {n_reads} in {N_READ_BATCHES} batches, "
        f"wrong={wrong}; misses: {BATCH} unloaded keys, wrong={wrong_miss}")
    log(f"[{name}] lookups/s end to end (host feature expansion, copies, "
        f"kernel): {n_reads / t_reads:.0f}")
    log(f"[{name}] launches: {counts}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; pool bytes "
        f"{stats['serving']['pool_bytes']} ({stats['n_nodes']} nodes, "
        f"{stats['n_entries']} entries, {stats['n_buckets']} buckets, "
        f"depth {stats['max_depth']})")
    if wrong or wrong_miss:
        fail(f"{name}: {wrong} wrong reads, {wrong_miss} wrong misses")
    if counts["fused_lookup"] == 0:
        fail(f"{name}: fused_lookup never launched on the main path")
    if nfl.use_flow and counts["nf_forward"] == 0:
        fail(f"{name}: nf_forward never launched on the main path")
    return {"name": name, "nfl": nfl, "keys": keys, "wl": wl,
            "unloaded": unloaded, "seed": seed, "miss_keys": miss_keys,
            "truth": Truth(wl.load_keys, wl.load_payloads),
            "batches": [k for _op, k, _p in wl.batches], "read_pay": pays,
            "use_flow": nfl.use_flow, "lookups_per_s": n_reads / t_reads,
            "peak_bytes": peak, "bulkload_s": t_bulk}


def rung_read(nfl, keys, budget, split_key_bits):
    """(payloads, z) of one batch through the index's own point-read
    dispatch with the rung that ``pool_budget=budget`` selects."""
    set_rung(nfl, budget)
    idx = nfl.index
    hi, lo = split_key_bits(keys)
    if nfl.use_flow:
        out = idx._flow_device_lookup(nfl._feats(keys), hi, lo,
                                      nfl._packed_w, nfl._shapes)
    else:
        out = idx._dispatch(keys.astype(np.float32).reshape(-1, 1), hi, lo,
                            None, True)
    path = idx.last_dispatch["path"]
    set_rung(nfl, None)
    if path != ("fused" if budget is None else "streamed"):
        fail(f"pool_budget={budget} served on the {path} rung")
    return out


def streamed_reads(res, win, split_key_bits, what, extra):
    """s1 / s3: the read batches and ``extra`` (name -> keys) through
    ``NFL.lookup_batch`` on the streamed rung, every read against the
    ground truth; then each read batch through both rungs, payloads and z
    bit-equal.  Returns the fused rung's (z, payloads) per batch."""
    name, nfl = res["name"], res["nfl"]
    truth = res["truth"]
    batches = res["batches"]
    want = [truth.lookup(k) for k in batches]
    extra = {n: (k, truth.lookup(k)) for n, k in extra.items()}
    set_rung(nfl, 0)

    def drive():
        wrong = n = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k, w in zip(batches, want):
            wrong += int((nfl.lookup_batch(k) != w).sum())
            n += k.shape[0]
        secs = time.perf_counter() - t
        bad = {}
        for n_, (k, w) in extra.items():
            got = np.concatenate([nfl.lookup_batch(k[i:i + BATCH])
                                  for i in range(0, k.shape[0], BATCH)])
            bad[n_] = int((got != w).sum())
        return wrong, n, secs, bad

    (wrong, n, secs, bad), counts = win.run(drive, streamed=True)
    set_rung(nfl, None)
    n_calls = len(batches) + sum(-(-k.shape[0] // BATCH)
                                 for k, _w in extra.values())
    log(f"[{name}] streamed rung ({what}): {n} reads in {len(batches)} "
        f"batches, wrong={wrong}; {bad}; {n / secs:.0f} lookups/s end to "
        f"end (fused rung in 2a: {res['lookups_per_s']:.0f}); launches "
        f"{counts}; serving {nfl.index.stats()['serving']}")
    if wrong or any(bad.values()):
        fail(f"{name}: wrong reads on the streamed rung ({what})")
    if counts["streamed_lookup"] != n_calls or counts["fused_lookup"]:
        fail(f"{name}: {n_calls} reads on the streamed rung launched "
             f"{counts['streamed_lookup']} streamed and "
             f"{counts['fused_lookup']} fused kernels")
    diff_pay = diff_z = 0
    fused = []
    for k in batches:
        fp, fz = rung_read(nfl, k, None, split_key_bits)
        sp_, sz = rung_read(nfl, k, 0, split_key_bits)
        diff_pay += int((fp != sp_).sum())
        diff_z += int((fz.view(np.int32) != sz.view(np.int32)).sum())
        fused.append((fz, fp))
    log(f"[{name}] both rungs on the {len(batches)} read batches ({what}): "
        f"payloads differ in {diff_pay}, z in {diff_z} (bound 0)")
    if diff_pay or diff_z:
        fail(f"{name}: the streamed rung disagrees with the fused rung")
    return dict(lookups_per_s=n / secs, fused=fused)


def root_probe(res, m, win, fused, split_key_bits):
    """s1: ``ops.index_probe`` on the root node of the fresh index with
    each read batch's z (driven, counted): where the root entry is DATA,
    its payload must be the one the fused rung served.  Returns the
    probe's device arguments per batch."""
    from repro_torch.kernels.fused_lookup import DATA, KIND_MODEL
    name, nfl = res["name"], res["nfl"]
    idx = nfl.index
    a = idx.arrays
    if int(a.node_kind[0]) != KIND_MODEL:
        fail(f"{name}: the root is not a model node; nothing to probe")
    if idx._tier_pack() is not None:
        fail(f"{name}: the fresh index holds shadows; the root's DATA hits "
             "are not the served payloads")
    size = int(a.node_size[0])
    pools = idx._kernel_pools()
    node = (float(a.node_slope[0]), float(a.node_intercept[0]),
            *(getattr(pools, f)[:size]
              for f in ("etype", "ehi", "elo", "epayload", "echild")))
    dev = torch.device("cuda")
    args = []
    for k, (fz, _fp) in zip(res["batches"], fused):
        hi, lo = split_key_bits(k)
        args.append((torch.from_numpy(fz).to(dev),
                     torch.from_numpy(hi.view(np.int32)).to(dev),
                     torch.from_numpy(lo.view(np.int32)).to(dev), *node))

    def drive():
        return [m.ops.index_probe(*x) for x in args]

    outs, counts = win.run(drive)
    wrong = n_data = n_hit = 0
    for (pay, code, _child), (_fz, fp) in zip(outs, fused):
        d = code.cpu().numpy() == DATA
        p = pay.cpu().numpy()
        wrong += int((p[d] != fp[d]).sum())
        n_data += int(d.sum())
        n_hit += int((p >= 0).sum())
    log(f"[{name}] root probe (ops.index_probe, {size} slots): "
        f"{len(args) * BATCH} queries, {n_data} land on DATA at the root, "
        f"{n_hit} hits, {wrong} disagree with the fused rung; launches "
        f"{counts}")
    if wrong or n_data == 0:
        fail(f"{name}: index_probe disagrees with the fused rung at the root")
    if counts["index_probe"] != len(args):
        fail(f"{name}: index_probe launched {counts['index_probe']} times "
             f"for {len(args)} batches")
    return args


def write_stream(res, m, win, n_batches, until_fold, alternate=False):
    """Phase 2b / 3b: ``write_heavy`` batches from the read phase's seed
    (so the load split is the one bulk-loaded).  Every read is checked;
    with ``until_fold`` the stream stops after the batch in which a fold
    that it started completes.  With ``alternate`` the odd batches read
    through the streamed rung."""
    name, nfl = res["name"], res["nfl"]
    idx = nfl.index
    wl = m.make_workload(res["keys"], m.WorkloadConfig(
        mix="write_heavy", n_ops=n_batches * BATCH, batch_size=BATCH,
        zipf_s=0.99, seed=res["seed"]))
    if not np.array_equal(wl.load_keys, res["wl"].load_keys):
        fail(f"{name}: the write workload's load split differs")
    folds0 = idx.n_rebuilds
    rec = collections.Counter()
    ins_k, ins_p, ins_ms = [], [], []
    fold_batches = []

    def drive():
        t = time.perf_counter()
        for b, (op, k, p) in enumerate(wl.batches):
            mid = idx._fold is not None
            r = op == 0
            streamed = alternate and b % 2 == 1
            set_rung(nfl, 0 if streamed else None)
            got = nfl.lookup_batch(k[r])
            set_rung(nfl, None)
            rec["wrong"] += int((got != p[r]).sum())
            rec["reads"] += int(r.sum())
            rec["mid_fold_reads"] += int(r.sum()) if mid else 0
            rec["streamed_calls"] += int(streamed)
            rec["mid_fold_streamed_reads"] += (int(r.sum())
                                               if mid and streamed else 0)
            t1 = time.perf_counter()
            nfl.insert_batch(k[~r], p[~r])
            ins_ms.append((time.perf_counter() - t1) * 1e3)
            rec["inserts"] += int((~r).sum())
            ins_k.append(k[~r])
            ins_p.append(p[~r])
            if mid or idx._fold is not None:
                fold_batches.append(b)
            if until_fold and idx.n_rebuilds > folds0:
                break
        return time.perf_counter() - t

    secs, counts = win.run(drive, streamed=alternate)
    res["truth"].insert(np.concatenate(ins_k), np.concatenate(ins_p))
    st = idx.stats()
    log(f"[{name}] writes: {len(ins_ms)} write_heavy batches of {BATCH}, "
        f"{rec['reads']} reads (wrong={rec['wrong']}), {rec['inserts']} "
        f"inserts in {secs:.2f} s = {rec['inserts'] / secs:.0f} inserts/s "
        f"with the reads; insert_batch ms median "
        f"{statistics.median(ins_ms):.1f} max {max(ins_ms):.1f}; run "
        f"{st['run_len']} delta {st['delta_len']}; folds "
        f"{idx.n_rebuilds - folds0}; batches with a fold in flight "
        f"{fold_batches}; reads served mid-fold {rec['mid_fold_reads']} "
        f"({rec['mid_fold_streamed_reads']} on the streamed rung, in "
        f"{rec['streamed_calls']} streamed read calls); launches {counts}")
    if idx.n_rebuilds > folds0:
        log(f"[{name}] in-stream fold: {st['last_fold']}")
    if rec["wrong"]:
        fail(f"{name}: {rec['wrong']} wrong reads during writes")
    if counts["fused_lookup"] == 0 or (nfl.use_flow
                                       and counts["nf_forward"] == 0):
        fail(f"{name}: the write path skipped a kernel")
    if until_fold and (idx.n_rebuilds == folds0
                       or rec["mid_fold_reads"] == 0):
        fail(f"{name}: no fold started and completed in-stream with reads "
             "served while it ran")
    if not until_fold and idx.n_rebuilds != folds0:
        fail(f"{name}: a fold ran during the write phase")
    if alternate and (rec["mid_fold_streamed_reads"] == 0
                      or counts["streamed_lookup"] != rec["streamed_calls"]):
        fail(f"{name}: {counts['streamed_lookup']} streamed launches for "
             f"{rec['streamed_calls']} streamed read calls, "
             f"{rec['mid_fold_streamed_reads']} streamed reads mid-fold")
    res["write"] = dict(rec, seconds=secs, batches=len(ins_ms),
                        insert_ms_median=statistics.median(ins_ms),
                        insert_ms_max=max(ins_ms),
                        fold_batches=fold_batches)
    res["write_batches"] = ins_k
    return np.concatenate(ins_k), np.concatenate(ins_p)


def readback(res, keys, win, what, streamed=False):
    """Look up ``keys`` in batches of 65,536 against the ground truth, on
    the streamed rung if ``streamed``."""
    nfl = res["nfl"]
    want = res["truth"].lookup(keys)
    set_rung(nfl, 0 if streamed else None)

    def drive():
        return [nfl.lookup_batch(keys[i:i + BATCH])
                for i in range(0, keys.shape[0], BATCH)]

    got, counts = win.run(drive, streamed=streamed)
    set_rung(nfl, None)
    wrong = int((np.concatenate(got) != want).sum())
    rung = "streamed" if streamed else "fused"
    log(f"[{res['name']}] {what} ({rung} rung): {keys.shape[0]} keys, "
        f"wrong={wrong}; launches {counts}")
    if wrong:
        fail(f"{res['name']}: {wrong} wrong lookups ({what}, {rung})")
    if streamed and (counts["streamed_lookup"] != len(got)
                     or counts["fused_lookup"]):
        fail(f"{res['name']}: {what} did not all take the streamed rung")


def update_and_delete(res, win, ins_keys):
    """Phase 2c: updates and deletes of loaded keys, then a tail of
    deletes, updates and inserts small enough to stay in the delta."""
    name, nfl = res["name"], res["nfl"]
    wl = res["wl"]
    rng = np.random.default_rng(res["seed"] + 100)
    pick = rng.choice(wl.load_keys.shape[0], 2 * BATCH + 2 * TAIL,
                      replace=False)
    upd = wl.load_keys[pick[:BATCH]]
    dele = wl.load_keys[pick[BATCH:2 * BATCH]]
    t_del = wl.load_keys[pick[2 * BATCH:2 * BATCH + TAIL]]
    t_upd = wl.load_keys[pick[2 * BATCH + TAIL:]]
    fresh = np.setdiff1d(res["unloaded"], ins_keys, assume_unique=True)
    t_ins = rng.choice(fresh, TAIL, replace=False)
    upd_pv = wl.load_payloads[pick[:BATCH]] + (1 << 28)
    t_upd_pv = wl.load_payloads[pick[2 * BATCH + TAIL:]] + (1 << 28)
    t_ins_pv = (1 << 29) + np.arange(TAIL)

    def drive():
        t = time.perf_counter()
        ok_u = nfl.update_batch(upd, upd_pv)
        ok_d = nfl.delete_batch(dele)
        secs = time.perf_counter() - t
        got_d = nfl.lookup_batch(dele)
        got_u = nfl.lookup_batch(upd)
        ok_t = nfl.delete_batch(t_del)
        ok_tu = nfl.update_batch(t_upd, t_upd_pv)
        nfl.insert_batch(t_ins, t_ins_pv)
        got_t = [nfl.lookup_batch(k) for k in (t_del, t_upd, t_ins)]
        return secs, ok_u, ok_d, got_d, got_u, ok_t, ok_tu, got_t

    (secs, ok_u, ok_d, got_d, got_u, ok_t, ok_tu, got_t), counts = win.run(
        drive)
    truth = res["truth"]
    truth.update(upd, upd_pv)
    truth.delete(dele)
    truth.delete(t_del)
    truth.update(t_upd, t_upd_pv)
    truth.insert(t_ins, t_ins_pv)
    wrong = {"update_ok": int((~ok_u).sum()) + int((~ok_tu).sum()),
             "delete_ok": int((~ok_d).sum()) + int((~ok_t).sum()),
             "deleted_hits": int((got_d != -1).sum())
             + int((got_t[0] != -1).sum()),
             "updated_reads": int((got_u != upd_pv).sum())
             + int((got_t[1] != t_upd_pv).sum()),
             "tail_inserts": int((got_t[2] != t_ins_pv).sum())}
    st = nfl.index.stats()
    log(f"[{name}] updates {BATCH}+{TAIL}, deletes {BATCH}+{TAIL}, tail "
        f"inserts {TAIL}: {2 * BATCH / secs:.0f} writes/s (update+delete); "
        f"wrong {wrong}; n_keys {st['n_keys']} (truth "
        f"{truth.keys.shape[0]}); run {st['run_len']} delta "
        f"{st['delta_len']}; launches {counts}")
    if any(wrong.values()) or st["n_keys"] != truth.keys.shape[0]:
        fail(f"{name}: wrong updates or deletes: {wrong}")
    if not (st["run_len"] and st["delta_len"]) or st["fold_active"]:
        fail(f"{name}: the tiers do not both hold data before the scans")
    res["deleted"] = np.concatenate([dele, t_del])
    res["updated"] = (upd, upd_pv)


def scan_truth(res, m, dev):
    """Live keys in positioning order (z from the NF kernel with the flow
    on, the f32 key without) and their payloads."""
    nfl, truth = res["nfl"], res["truth"]
    keys = truth.keys
    if nfl.use_flow:
        z = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, keys,
                                    nfl.cfg.flow, dev).astype(np.float32)
    else:
        z = keys.astype(np.float32)
    order = np.argsort(z, kind="stable")
    return keys[order], z[order], truth.pv[order]


def scan_queries(res, m, sorted_keys, n_batches):
    """YCSB workload E ranges: start ranks zipfian (0.99) over the live
    keys in positioning order, lengths uniform in 1-100."""
    rng = np.random.default_rng(res["seed"] + 200)
    n = sorted_keys.shape[0]
    total = n_batches * SCAN_BATCH
    start = m.zipf_indices(rng, n - 101, total, 0.99)
    length = rng.integers(1, 101, total)
    return [(start[i:i + SCAN_BATCH], length[i:i + SCAN_BATCH])
            for i in range(0, total, SCAN_BATCH)]


def run_scans(res, win, sk, zs, ps, queries, what):
    """Drive ``scan_batch`` per batch (counted), then hold each
    untruncated range to the z-space ground truth as a multiset."""
    nfl = res["nfl"]
    sharded = hasattr(nfl.index, "shards")

    def drive():
        out = []
        t = time.perf_counter()
        for r, ln in queries:
            out.append(nfl.scan_batch(sk[r], sk[r + ln]))
        return out, time.perf_counter() - t

    (outs, secs), counts = win.run(drive)
    wrong = truncated = n_rows = 0
    for (r, ln), (pv, cnt, tot) in zip(queries, outs):
        a = np.searchsorted(zs, zs[r], side="left")
        b = np.searchsorted(zs, zs[r + ln], side="left")
        q = np.flatnonzero(tot <= SCAN_CAP)
        truncated += r.shape[0] - q.shape[0]
        bad = cnt[q] != b[q] - a[q]
        ok = q[~bad]
        want = ps[ranges(a[ok], b[ok] - a[ok])]
        wq = np.repeat(np.arange(ok.shape[0]), b[ok] - a[ok])
        got_mask = np.arange(SCAN_CAP)[None, :] < cnt[ok][:, None]
        got = pv[ok][got_mask]
        gq = np.repeat(np.arange(ok.shape[0]), cnt[ok])
        w_o, g_o = np.lexsort((want, wq)), np.lexsort((got, gq))
        diff = want[w_o] != got[g_o]
        wrong += int(bad.sum()) + int(np.unique(wq[w_o][diff]).shape[0])
        n_rows += int(cnt.sum())
    n_q = sum(r.shape[0] for r, _ln in queries)
    log(f"[{res['name']}] scans ({what}): {len(queries)} batches, {n_q} "
        f"ranges, {n_rows} rows, wrong={wrong}, truncated="
        f"{truncated} (counter {counts['scan_truncated']}); {n_q / secs:.0f} "
        f"scans/s end to end, {n_rows / secs:.0f} rows/s; launches {counts}")
    if wrong:
        fail(f"{res['name']}: {wrong} wrong range scans ({what})")
    # one launch a batch; sharded, one a shard that the batch's ranges
    # reach by their ground-truth z, and one router NF launch a batch
    # with the flow on
    want = (sum(shards_reached(nfl.index.boundaries, zs[r], zs[r + ln])
                for r, ln in queries) if sharded else len(queries))
    want_nf = len(queries) if sharded and nfl.use_flow else 0
    if counts["fused_range_scan"] != want or counts["nf_forward"] != want_nf:
        fail(f"{res['name']}: fused_range_scan launched "
             f"{counts['fused_range_scan']} times (expected {want}) and "
             f"nf_forward {counts['nf_forward']} (expected {want_nf}) for "
             f"{len(queries)} scan batches")
    return dict(scans_per_s=n_q / secs, rows_per_s=n_rows / secs,
                truncated=truncated, seconds=secs)


def shards_reached(boundaries, zlo, zhi) -> int:
    """How many shards a batch of ``[zlo, zhi)`` ranges reaches: shard
    ``s`` owns ``[B[s-1], B[s])``, so a non-empty range reaches every
    shard from the one that holds ``zlo`` to the one below the first
    boundary at or past ``zhi``."""
    b = np.asarray(boundaries, np.float32)
    ne = zhi > zlo
    cover = np.zeros(b.shape[0] + 2, np.int64)
    np.add.at(cover, np.searchsorted(b, zlo[ne], side="right"), 1)
    np.add.at(cover, np.searchsorted(b, zhi[ne], side="left") + 1, -1)
    return int((np.cumsum(cover)[:b.shape[0] + 1] > 0).sum())


def batch_shards(res, m, keys) -> int:
    """How many shards a point batch reaches: its ground-truth z (the
    bulk transform) binned at the boundaries here, apart from the
    router's own counters."""
    nfl = res["nfl"]
    z = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, keys,
                                nfl.cfg.flow).astype(np.float32)
    return int(np.unique(np.searchsorted(nfl.index.boundaries, z,
                                         side="right")).shape[0])


def scan_args(nfl, sk, queries, dev):
    """Device arguments of the range kernel for each scan batch, on the
    index's current pools and tiers."""
    idx = nfl.index

    def feats(k):
        if nfl.use_flow:
            f = nfl._feats(k)
        else:
            f = k.astype(np.float32).reshape(-1, 1)
        return torch.from_numpy(np.ascontiguousarray(f)).to(dev)

    sp, tp = idx._serving.scan_pack(), idx._tier_pack()
    return [(feats(sk[r]), feats(sk[r + ln]), nfl._packed_w, sp, tp)
            for r, ln in queries]


def lookup_args(nfl, keys, dev, split_key_bits):
    hi, lo = split_key_bits(keys)
    if nfl.use_flow:
        f = nfl._feats(keys)
    else:
        f = keys.astype(np.float32).reshape(-1, 1)
    idx = nfl.index
    return (torch.from_numpy(np.ascontiguousarray(f)).to(dev),
            torch.from_numpy(hi.view(np.int32)).to(dev),
            torch.from_numpy(lo.view(np.int32)).to(dev),
            nfl._packed_w, idx._kernel_pools(), idx._tier_pack())


def lookup_kw(nfl):
    idx = nfl.index
    return dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
                max_depth=idx.max_depth,
                dense_iters=idx.cfg.dense_search_iters,
                bucket_cap=idx.cfg.max_bucket,
                dense_window=idx.dense_window, use_flow=nfl.use_flow)


# ------------------------------------------------------ sharded serving
def sharded_load_and_read(base, m, win):
    """Phase 4a: the longlat load of phase 2 (same keys, seed and loaded
    half) through ``NFL(NFLConfig(backend="flat", shards=4))`` on the
    card, AutoSwitch deciding (rerun with ``force_flow=True`` if it
    declines)."""
    wl = base["wl"]

    def bulkload(force):
        torch.cuda.reset_peak_memory_stats()
        nfl = m.NFL(m.NFLConfig(
            backend="flat", shards=N_SHARDS, force_flow=force,
            flow_train=m.FlowTrainConfig(epochs=SHARDED_FLOW_EPOCHS)))
        t = time.perf_counter()
        nfl.bulkload(wl.load_keys, wl.load_payloads)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    def load():
        nfl, t_bulk = bulkload(None)
        if not nfl.use_flow:
            log(f"[sharded] AutoSwitch declined the flow (tails "
                f"{nfl.metrics['tail_conflict_original']:.0f} -> "
                f"{nfl.metrics['tail_conflict_transformed']:.0f}); "
                "rerunning with force_flow=True")
            m.ops.reset_launch_counts()
            nfl, t_bulk = bulkload(True)
        return nfl, t_bulk

    (nfl, t_bulk), counts = win.run(load)
    peak = torch.cuda.max_memory_allocated()
    idx = nfl.index
    st = nfl.stats()
    mt = nfl.metrics
    log(f"[sharded] {N_SHARDS} shards on {st['devices']}, boundaries "
        f"{st['boundaries']}; use_flow={nfl.use_flow}")
    for s, sh in enumerate(st["shards"]):
        log(f"[sharded] shard {s}: {sh['n_keys']} keys, depth "
            f"{sh['max_depth']}, pool bytes {sh['serving']['pool_bytes']} "
            f"({sh['n_nodes']} nodes), shadowed {sh['n_shadowed']}, "
            f"AutoSwitch {sh['autoswitch']}")
    log(f"[sharded] bulkload {t_bulk:.2f} s = train {mt['flow_train_s']:.2f} "
        f"s + transform {mt['transform_s']:.2f} s + build and verify "
        f"{mt['index_build_s']:.2f} s (single index, phase 2: "
        f"{base['bulkload_s']:.2f} s); sharded verify repaired "
        f"{mt['serve_verify_shadowed']:.0f} keys (expected 0); launches "
        f"{counts}; max_memory_allocated {peak / 2**30:.2f} GiB (single "
        f"index after its bulkload and reads: "
        f"{base['peak_bytes'] / 2**30:.2f} GiB)")
    if not nfl.use_flow:
        fail("sharded: the flow is off")
    if st["n_keys"] != wl.load_keys.shape[0]:
        fail(f"sharded: {st['n_keys']} keys indexed of "
             f"{wl.load_keys.shape[0]}")
    return {"name": "sharded", "nfl": nfl, "keys": base["keys"], "wl": wl,
            "unloaded": base["unloaded"], "seed": base["seed"],
            "miss_keys": base["miss_keys"], "batches": base["batches"],
            "truth": Truth(wl.load_keys, wl.load_payloads), "use_flow": True,
            "bulkload_s": t_bulk, "peak_bytes": peak}


def sharded_reads(res, win, what, single=None):
    """The 64 read batches through ``NFL.lookup_batch``, each in its own
    launch window: one router ``nf_forward`` and one ``fused_lookup``
    per shard that its keys reach (``res["batch_shards"]``); every read
    against the ground truth and, on the fresh index, against the single
    index's payloads of phase 2a."""
    nfl = res["nfl"]
    truth = res["truth"]
    wrong = diff = n = 0
    bad = []
    secs = 0.0
    for b, (k, segs) in enumerate(zip(res["batches"],
                                      res["batch_shards"])):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, c = win.run(lambda k=k: nfl.lookup_batch(k))
        secs += time.perf_counter() - t
        if (c["nf_forward"], c["fused_lookup"], c["streamed_lookup"],
                c["index_probe"]) != (1, segs, 0, 0):
            bad.append((b, segs, c))
        wrong += int((got != truth.lookup(k)).sum())
        if single is not None:
            diff += int((got != single[b]).sum())
        n += k.shape[0]
    log(f"[sharded] reads ({what}): {n} in {len(res['batches'])} batches, "
        f"wrong={wrong}, differ from the single index's (phase 2a) "
        f"{diff if single is not None else 'not compared'}; "
        f"{n / secs:.0f} lookups/s end to end; launch windows off "
        f"{bad[:3]} ({len(bad)} batches)")
    if wrong or diff or bad:
        fail(f"sharded: {wrong} wrong reads, {diff} differ from the single "
             f"index, {len(bad)} batches with wrong launch windows")
    return n / secs


def router_z_check(res, split_key_bits):
    """The router's z (``route_flow``: the NF kernel) against the fused
    rung's z (NF in ``fused_lookup``) on every read batch: bit-equal.
    Compare-only launches, outside the windows."""
    nfl = res["nfl"]
    idx = nfl.index
    diff = 0
    for k in res["batches"]:
        feats = nfl._feats(k)
        z, _sid = idx._route_flow(feats, nfl._packed_w, nfl._shapes)
        hi, lo = split_key_bits(k)
        _p, zf = idx.shards[0]._flow_device_lookup(feats, hi, lo,
                                                   nfl._packed_w, nfl._shapes)
        diff += int((z.view(np.int32) != zf.view(np.int32)).sum())
    log(f"[sharded] router z against the fused rung's z on "
        f"{len(res['batches'])} read batches: {diff} differ (bound 0)")
    if diff:
        fail("sharded: the router's z differs from the fused rung's")


def sharded_async(res, win, single):
    """Two read batches through ``NFL.lookup_batch_async``, both in flight
    before either finishes (finished in reverse order)."""
    nfl = res["nfl"]
    b0, b1 = res["batches"][:2]

    def drive():
        f0 = nfl.lookup_batch_async(b0)
        f1 = nfl.lookup_batch_async(b1)
        return f1(), f0()

    (r1, r0), c = win.run(drive)
    diff = int((r0 != single[0]).sum()) + int((r1 != single[1]).sum())
    log(f"[sharded] two batches in flight through lookup_batch_async: "
        f"{diff} reads differ from the single index's; launches {c}")
    if diff or c["nf_forward"] != 2:
        fail("sharded: wrong async reads")


def busy_shard_writes(res, m, win):
    """``write_heavy`` batches of 65,536 aimed at one shard: 80% inserts
    of unloaded keys whose z routes to shard ``BUSY_SHARD``, 20% reads of
    live keys over all shards (a quarter of them among the keys inserted
    so far), until that shard's fold starts and completes in-stream.
    Every read is checked, those served mid-fold included; the other
    shards must not fold.  Then every inserted key is read back."""
    from repro_torch.kernels.shard_dispatch import route
    nfl = res["nfl"]
    idx = nfl.index
    busy = idx.shards[BUSY_SHARD]
    truth = res["truth"]
    rng = np.random.default_rng(res["seed"] + 400)
    z = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer,
                                res["unloaded"], nfl.cfg.flow)
    pool = res["unloaded"][route(z.astype(np.float32), idx.boundaries)
                           == BUSY_SHARD]
    del z
    # the miss batch stays unloaded
    pool = rng.permutation(pool[~np.isin(pool, res["miss_keys"])])
    n_ins = BATCH * 4 // 5
    loaded, loaded_pv = truth.keys, truth.pv
    rebuilds0 = [sh.n_rebuilds for sh in idx.shards]
    writes0 = list(idx._router["per_shard_writes"])
    rec = collections.Counter()
    ins_ms, fold_batches = [], []
    ins_k = np.empty(0, np.float64)
    ins_p = np.empty(0, np.int64)

    def drive():
        nonlocal ins_k, ins_p
        t = time.perf_counter()
        for b in range(MAX_SHARD_WRITE_BATCHES):
            mid = busy._fold is not None
            n_old = BATCH - n_ins
            if ins_k.shape[0]:
                n_new = n_old // 4
                j = rng.integers(0, ins_k.shape[0], n_new)
                qk, qp = ins_k[j], ins_p[j]
            else:
                n_new = 0
                qk = qp = np.empty(0)
            j = rng.integers(0, loaded.shape[0], n_old - n_new)
            q = np.concatenate([loaded[j], qk])
            want = np.concatenate([loaded_pv[j], qp])
            got = nfl.lookup_batch(q)
            rec["wrong"] += int((got != want).sum())
            rec["reads"] += q.shape[0]
            rec["mid_fold_reads"] += q.shape[0] if mid else 0
            k = pool[b * n_ins:(b + 1) * n_ins]
            if not k.shape[0]:
                fail(f"sharded: the unloaded keys of shard {BUSY_SHARD} ran "
                     f"out after {b} batches with its fold unfinished")
            p = (1 << 27) + b * n_ins + np.arange(k.shape[0])
            t1 = time.perf_counter()
            nfl.insert_batch(k, p)
            ins_ms.append((time.perf_counter() - t1) * 1e3)
            ins_k = np.concatenate([ins_k, k])
            ins_p = np.concatenate([ins_p, p])
            if mid or busy._fold is not None:
                fold_batches.append(b)
            if busy.n_rebuilds > rebuilds0[BUSY_SHARD]:
                break
        return time.perf_counter() - t

    secs, counts = win.run(drive)
    truth.insert(ins_k, ins_p)
    rebuilds = [sh.n_rebuilds for sh in idx.shards]
    writes = [a - b for a, b in zip(idx._router["per_shard_writes"], writes0)]
    log(f"[sharded] busy-shard writes: {len(ins_ms)} batches of {BATCH}, "
        f"{rec['reads']} reads (wrong={rec['wrong']}), {ins_k.shape[0]} "
        f"inserts routed {writes} in {secs:.2f} s = "
        f"{ins_k.shape[0] / secs:.0f} inserts/s with the reads; "
        f"insert_batch ms median {statistics.median(ins_ms):.1f} max "
        f"{max(ins_ms):.1f}; n_rebuilds {rebuilds0} -> {rebuilds}; batches "
        f"with the fold in flight {fold_batches}; reads served mid-fold "
        f"{rec['mid_fold_reads']}; launches {counts}")
    log(f"[sharded] shard {BUSY_SHARD} in-stream fold: {busy.last_fold}")
    others = [s for s in range(N_SHARDS) if s != BUSY_SHARD]
    if rec["wrong"]:
        fail(f"sharded: {rec['wrong']} wrong reads during the writes")
    if rebuilds[BUSY_SHARD] == rebuilds0[BUSY_SHARD] \
            or rec["mid_fold_reads"] == 0:
        fail("sharded: the busy shard did not fold in-stream with reads "
             "served while it ran")
    if any(rebuilds[s] != rebuilds0[s] or writes[s] for s in others):
        fail("sharded: writes or a fold reached the other shards")
    if counts["streamed_lookup"] or counts["index_probe"]:
        fail("sharded: the write phase launched an unexpected kernel")
    res["write"] = dict(rec, seconds=secs, batches=len(ins_ms),
                        inserts=int(ins_k.shape[0]),
                        inserts_per_s=ins_k.shape[0] / secs,
                        insert_ms_median=statistics.median(ins_ms),
                        insert_ms_max=max(ins_ms), fold=busy.last_fold)
    return ins_k


def sharded_update_delete(res, win):
    """65,536 updates and 65,536 deletes of loaded keys across all shards:
    deleted keys miss, updated keys read their new payloads."""
    nfl = res["nfl"]
    wl = res["wl"]
    rng = np.random.default_rng(res["seed"] + 500)
    pick = rng.choice(wl.load_keys.shape[0], 2 * BATCH, replace=False)
    upd, dele = wl.load_keys[pick[:BATCH]], wl.load_keys[pick[BATCH:]]
    upd_pv = wl.load_payloads[pick[:BATCH]] + (1 << 28)

    def drive():
        t = time.perf_counter()
        ok_u = nfl.update_batch(upd, upd_pv)
        ok_d = nfl.delete_batch(dele)
        secs = time.perf_counter() - t
        return secs, ok_u, ok_d, nfl.lookup_batch(dele), nfl.lookup_batch(upd)

    (secs, ok_u, ok_d, got_d, got_u), counts = win.run(drive)
    truth = res["truth"]
    truth.update(upd, upd_pv)
    truth.delete(dele)
    wrong = {"update_ok": int((~ok_u).sum()), "delete_ok": int((~ok_d).sum()),
             "deleted_hits": int((got_d != -1).sum()),
             "updated_reads": int((got_u != upd_pv).sum())}
    st = nfl.stats()
    log(f"[sharded] updates {BATCH}, deletes {BATCH}: "
        f"{2 * BATCH / secs:.0f} writes/s; wrong {wrong}; n_keys "
        f"{st['n_keys']} (truth {truth.keys.shape[0]}); run {st['run_len']} "
        f"delta {st['delta_len']}; launches {counts}")
    if any(wrong.values()) or st["n_keys"] != truth.keys.shape[0]:
        fail(f"sharded: wrong updates or deletes: {wrong}")
    res["deleted"] = dele
    res["writes_per_s"] = 2 * BATCH / secs


def straddling_queries(res, zs):
    """One batch of ``STRADDLE`` ranges per boundary, each starting within
    100 ranks below the boundary (in z order of the live keys) and
    ending 2-29 ranks past it."""
    rng = np.random.default_rng(res["seed"] + 600)
    rs, lns = [], []
    for bnd in res["nfl"].index.boundaries:
        b = int(np.searchsorted(zs, bnd, side="left"))
        r = b - rng.integers(1, 101, STRADDLE)
        rs.append(r)
        lns.append(np.minimum(b - r + rng.integers(2, 30, STRADDLE),
                              zs.shape[0] - 1 - r))
    return [(np.concatenate(rs), np.concatenate(lns))]


def sharded_profile(res, split_key_bits):
    """One read batch split into its host steps (feature expansion, the
    route, the plan, the per-shard issue, the wait for the shards'
    kernels and copies, the gather), the median over the 64 batches; and
    one batch under ``torch.profiler``: the kernels' device time, and
    whether the shards' ``fused_lookup`` launches overlap on the card.
    Informational: nothing here fails the smoke but a wrong read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.shard_dispatch import fanout_plan
    nfl = res["nfl"]
    idx = nfl.index
    truth = res["truth"]
    parts = collections.defaultdict(list)
    for k in res["batches"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = nfl._feats(k)
        t1 = time.perf_counter()
        z, sids = idx._route_flow(feats, nfl._packed_w, nfl._shapes)
        t2 = time.perf_counter()
        segs, inv = fanout_plan(sids, idx.n_shards)
        t3 = time.perf_counter()
        fins = [sh.lookup_batch_async(z[seg], ikeys=k[seg], stream=st)
                for sh, st, seg in zip(idx.shards, idx.streams, segs)
                if seg.shape[0]]
        t4 = time.perf_counter()
        got = [f() for f in fins]
        t5 = time.perf_counter()
        out = np.concatenate(got)[inv]
        t6 = time.perf_counter()
        if not np.array_equal(out, truth.lookup(k)):
            fail("sharded: the profiled read batch is wrong")
        for name, a, b in (("features", t0, t1), ("route", t1, t2),
                           ("plan", t2, t3), ("issue", t3, t4),
                           ("wait", t4, t5), ("gather", t5, t6),
                           ("total", t0, t6)):
            parts[name].append((b - a) * 1e3)
    split = {name: statistics.median(v) for name, v in parts.items()}
    k = res["batches"][0]
    prof_out = {"split_ms": split}
    try:
        nfl.lookup_batch(k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            nfl.lookup_batch(k)
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:          # informational: never fails the smoke
        log(f"[sharded] read batch profile: not measured ({exc!r})")
        evs = []
    if evs:
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in evs)
        busy, end = 0.0, None
        for a, b, _n in spans:
            if end is None or a >= end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        look = [(a, b) for a, b, n in spans if "fused_lookup_kernel" in n]
        overlap = sum(1 for i in range(len(look)) for j in range(i)
                      if look[j][1] > look[i][0])
        prof_out.update(
            device_ops=len(evs),
            device_busy_ms=busy / 1e3,
            window_ms=(spans[-1][1] - spans[0][0]) / 1e3,
            kernels_ms={n[:48]: (b - a) / 1e3 for a, b, n in spans
                        if "kernel" in n or "vec4" in n},
            lookup_kernels=len(look), overlapping_pairs=overlap)
    log(f"[sharded] read batch of {BATCH}, host ms (median of "
        f"{len(res['batches'])}): "
        + ", ".join(f"{n_} {v:.3f}" for n_, v in split.items())
        + f"; under torch.profiler: {json.dumps(prof_out.get('kernels_ms', 'not measured'))}, "
        f"{prof_out.get('device_ops', 'not measured')} device operations, "
        f"device busy {prof_out.get('device_busy_ms', 'not measured')} ms "
        f"of a {prof_out.get('window_ms', 'not measured')} ms window; "
        f"fused_lookup launches {prof_out.get('lookup_kernels')}, "
        f"overlapping pairs {prof_out.get('overlapping_pairs')}")
    return prof_out


def sharded_phase(base, m, win, split_key_bits, dev):
    """Phase 4: sharded serving, ``NFL(shards=4)`` on one card."""
    res = sharded_load_and_read(base, m, win)
    nfl = res["nfl"]
    res["batch_shards"] = [batch_shards(res, m, k) for k in res["batches"]]
    single = base["read_pay"]
    res["lookups_per_s"] = sharded_reads(res, win, "fresh index", single)
    readback(res, res["miss_keys"], win, "misses (unloaded keys)")
    router_z_check(res, split_key_bits)
    sharded_async(res, win, single)
    res["profile"] = sharded_profile(res, split_key_bits)
    ins_k = busy_shard_writes(res, m, win)
    readback(res, ins_k, win, "inserted keys read back")
    del ins_k
    sharded_update_delete(res, win)
    sk, zs, ps = scan_truth(res, m, dev)
    queries = scan_queries(res, m, sk, N_SCAN_BATCHES)
    res["scan"] = run_scans(res, win, sk, zs, ps, queries, "YCSB E")
    router = nfl.index._router
    straddled = router["straddling_ranges"]
    st_q = straddling_queries(res, zs)
    run_scans(res, win, sk, zs, ps, st_q, "straddling every boundary")
    straddled = router["straddling_ranges"] - straddled
    log(f"[sharded] straddling ranges merged: {straddled} of "
        f"{st_q[0][0].shape[0]} (need {STRADDLE * (N_SHARDS - 1)})")
    if straddled < STRADDLE * (N_SHARDS - 1):
        fail(f"sharded: only {straddled} ranges straddled a boundary")
    t0 = time.perf_counter()
    rebuilds0 = [sh.n_rebuilds for sh in nfl.index.shards]
    _none, counts = win.run(nfl.index.rebuild)
    st = nfl.stats()
    log(f"[sharded] rebuild(): {time.perf_counter() - t0:.2f} s; "
        f"n_rebuilds {rebuilds0} -> "
        f"{[sh['n_rebuilds'] for sh in st['shards']]}; folds "
        f"{[sh['last_fold'] for sh in st['shards']]}; launches {counts}")
    if any(sh["n_rebuilds"] <= r0 or sh["run_len"] != sh["n_shadowed"]
           for sh, r0 in zip(st["shards"], rebuilds0)):
        fail("sharded: rebuild did not fold every shard's tiers")
    sharded_reads(res, win, "after rebuild")
    readback(res, res["deleted"], win, "deleted keys after rebuild")
    readback(res, res["miss_keys"], win, "misses after rebuild")
    run_scans(res, win, sk, zs, ps, queries[:1], "after rebuild")
    log(f"[sharded] router counters {json.dumps(st['router'])}")
    log(f"[sharded] end to end against the single index (phase 2): "
        f"lookups/s {res['lookups_per_s']:.0f} vs {base['lookups_per_s']:.0f};"
        f" inserts/s {res['write']['inserts_per_s']:.0f} (busy shard) vs "
        f"{base['write']['inserts'] / base['write']['seconds']:.0f}; "
        f"scans/s {res['scan']['scans_per_s']:.0f} vs "
        f"{base['scan']['scans_per_s']:.0f}; max_memory_allocated since the "
        f"bulkload {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {key: res[key] for key in ("lookups_per_s", "write", "scan",
                                      "profile", "bulkload_s",
                                      "writes_per_s")}


# ------------------------------------------------- kernels vs plain
def nf_sass_per_key(shapes):
    """FP32 and SFU instructions per key of the default flow's
    ``nf_forward`` kernel, counted in the SASS of the built library
    (``cuobjdump -sass``): its FADD, FMUL, FFMA, FSETP, FSEL and FMNMX
    (one FP32 issue slot each) and its MUFU, over the keys its code
    evaluates (one MUFU.EX2 per accurate tanhf, one tanhf per hidden unit
    of every layer but the last)."""
    import re
    import shutil

    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._lib_path("nf_forward"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f.startswith("_Z15nf_forward_vec4"))
    ops = collections.Counter(op.split(".")[0] for op in re.findall(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
    ex2 = len(re.findall(r"MUFU\.EX2", body))
    tanh = sum(o for o, _ in shapes[:-1])
    keys = ex2 / tanh
    fp32 = sum(ops[o] for o in ("FADD", "FMUL", "FFMA", "FSETP", "FSEL",
                                "FMNMX"))
    return fp32 / keys, ops["MUFU"] / keys, keys


def nf_forward_row(res, k, flush_buf, write_batches):
    """nf_forward against plain on the bulk load's keys, timed there and
    at the write batches' size (their inserts' positioning keys), with
    its bound the largest of its bytes, its FP32 issue and its SFU
    operations (counted in its SASS)."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    cfg = nfl.cfg.flow
    feats = torch.from_numpy(nfl._feats(res["wl"].load_keys)).to(dev)
    packed, shapes = nfl._packed_w, nfl._shapes
    zk = k.nf_forward(feats, packed, shapes, cfg.dim)
    zp = k.nf_forward_plain(feats, packed, shapes, cfg.dim)
    torch.cuda.synchronize()
    ulps = ulp_diff(zk, zp)
    err = float((zk - zp).abs().max().item())
    log(f"nf_forward vs plain on {feats.shape[0]} keys: max |dz| {err}, "
        f"max ulp diff {ulps} (bound 0: same op order, one rounding each, "
        "both on the card's tanhf)")
    if ulps != 0:
        fail("nf_forward disagrees with its plain version")
    w = packed.reshape(-1).to(dev)
    d = cfg.dim
    weights = []
    i = 2 * d
    for n_out, n_in in shapes:
        weights.append((w[i:i + n_out * n_in].reshape(n_out, n_in),
                        w[i + n_out * n_in:i + n_out * n_in + n_out]))
        i += n_out * n_in + n_out
    mu, sd_inv, scale = w[:d], w[d:2 * d], w[i:i + d]

    def library():
        # the same function as dense PyTorch ops (cuBLAS products)
        h = (feats - mu) * sd_inv
        for li, (wt, b) in enumerate(weights):
            h = torch.addmm(b, h, wt.T)
            if li < len(weights) - 1:
                h = torch.tanh(h)
        return (h * scale).sum(dim=1)

    b = feats.shape[0]
    fp32_key, sfu_key, sass_keys = nf_sass_per_key(shapes)
    fp32_s, sfu_s = sm_rates()
    times = {"bytes": b * (4 * d + 4) / HBM_BYTES_PER_S,
             "operations (FP32 issue)": b * fp32_key / fp32_s,
             "operations (SFU)": b * sfu_key / sfu_s}
    bound_by = max(times, key=times.get)
    bound_ms = times[bound_by] * 1e3

    def kernel():
        return k.nf_forward(feats, packed, shapes, d)

    # cold L2: each call alone after a flush, the median of 5
    cold = launch_times_ms([kernel] * 5, flush_buf.zero_)
    lib_cold = launch_times_ms([library] * 5, flush_buf.zero_)
    host = host_ms_per_call([kernel] * 20)
    wfeats = [torch.from_numpy(nfl._feats(x)).to(dev) for x in write_batches]
    for f in wfeats[:2]:
        if not bit_equal(k.nf_forward(f, packed, shapes, d),
                         k.nf_forward_plain(f, packed, shapes, d)):
            fail("nf_forward disagrees with plain on a write batch")
    wcold, wwarm, whost = timed_launches(
        [lambda f=f: k.nf_forward(f, packed, shapes, d) for f in wfeats],
        flush_buf)
    wb = statistics.median(f.shape[0] for f in wfeats)
    row = {
        "name": "nf_forward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nf_forward.cu",
        "replaces": "src/repro/kernels/nf_forward.py:113",
        "launches": None, "max_abs_err": err,
        "ms": statistics.median(cold),
        "plain_ms": time_ms(lambda: k.nf_forward_plain(feats, packed, shapes,
                                                       d), 5, 1),
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_by == "bytes" else "operations",
        "library_ms": statistics.median(lib_cold),
        "ms_back_to_back": time_ms(kernel, 20),
        "library_ms_back_to_back": time_ms(library, 5, 1),
        "host_ms_per_call": host,
        "bound_ms_by": {key: v * 1e3 for key, v in times.items()},
        "fp32_per_key": fp32_key, "sfu_per_key": sfu_key,
        "write_batch_keys": wb,
        "ms_write_batch": statistics.median(wcold),
        "ms_warm_l2_write_batch": statistics.median(wwarm),
        "host_ms_per_call_write_batch": whost,
    }
    log(f"nf_forward: {b} keys {row['ms']:.5f} ms cold L2 (back to back "
        f"{row['ms_back_to_back']:.5f}), host issue {host:.5f} ms/call; "
        f"the write batches ({len(wfeats)}, median {wb:.0f} keys) "
        f"{row['ms_write_batch']:.5f} ms cold, {row['ms_warm_l2_write_batch']:.5f} "
        f"warm, host {whost:.5f}; per key {fp32_key:.1f} FP32 and "
        f"{sfu_key:.1f} SFU instructions (SASS, {sass_keys:.0f} keys of "
        f"code); bound {bound_ms:.5f} ms by {bound_by} "
        f"({ {key: round(v * 1e3, 5) for key, v in times.items()} }); "
        f"library {row['library_ms']:.4f} ms")
    return row


def compare_lookup(res, args, kw, k, what):
    """fused_lookup against its plain version on one batch: payloads and
    z bit-equal, and z equal to nf_forward's with the flow on."""
    nfl = res["nfl"]
    pk, zk = k.fused_lookup(*args, **kw)
    pp, zp = k.fused_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    pay_eq, z_eq = bit_equal(pk, pp), bit_equal(zk, zp)
    err = max(float((pk - pp).abs().max().item()),
              float((zk - zp).abs().max().item()))
    log(f"fused_lookup vs plain, {res['name']} ({what}), "
        f"{args[0].shape[0]} queries: payloads bit-equal {pay_eq}, z "
        f"bit-equal {z_eq}")
    if not (pay_eq and z_eq):
        fail(f"fused_lookup disagrees with its plain version ({what})")
    if nfl.use_flow:
        zf = k.nf_forward(args[0], nfl._packed_w, nfl._shapes,
                          nfl.cfg.flow.dim)
        if not bit_equal(zk, zf):
            fail("in-kernel NF z differs from nf_forward z")
        log("fused_lookup z equals nf_forward z bit for bit: True")
    return pk, zk, err


def time_lookup(res, k, split_key_bits, flush_buf):
    """Phase 5, on the fresh index: fused_lookup against plain on the
    first read batch, then timed launch by launch over all 64."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    kw = lookup_kw(nfl)
    batches = [lookup_args(nfl, b, dev, split_key_bits)
               for b in res["batches"]]
    args = batches[0]
    _pk, zk, err = compare_lookup(res, args, kw, k, "fresh index")
    sectors, n_reads, mean_depth = touched_sectors(
        args[4], zk, args[1], args[2], kw, args[5])
    io = BATCH * (4 * args[0].shape[1] + 8 + 8)
    bound = (sectors * SECTOR + io) / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.fused_lookup(*a, **kw) for a in batches]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.fused_lookup_plain(*args, **kw), 3, 1)
    flow = "on" if nfl.use_flow else "off"
    log(f"fused_lookup flow={flow}: median over {len(fns)} distinct "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; plain {plain_ms:.3f} ms; mean depth "
        f"{mean_depth:.3f}; {n_reads / BATCH:.2f} reads/query in "
        f"{sectors} distinct sectors ({sectors / BATCH:.3f}/query); "
        f"bound {bound:.6f} ms")
    # the fold verify's launches: VERIFY_CHUNK keys in key order, no tiers
    srt = np.sort(res["wl"].load_keys)
    step = srt.shape[0] // N_VERIFY_CHUNKS
    chunks = [lookup_args(nfl, srt[i * step:i * step + VERIFY_CHUNK], dev,
                          split_key_bits)[:5] + (None,)
              for i in range(N_VERIFY_CHUNKS)]
    compare_lookup(res, chunks[0], kw, k, "verify chunk")
    vcold, vwarm, vhost = timed_launches(
        [lambda a=a: k.fused_lookup(*a, **kw) for a in chunks], flush_buf)
    vms = statistics.median(vcold)
    log(f"fused_lookup flow={flow} at the verify chunk ({VERIFY_CHUNK} "
        f"keys in key order, no tiers): median over {len(chunks)} chunks "
        f"{vms:.5f} ms cold L2 (min {min(vcold):.5f}, max "
        f"{max(vcold):.5f}), {statistics.median(vwarm):.5f} ms warm L2; "
        f"host issue {vhost:.5f} ms/call")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, ms_warm_l2=ms_warm,
                host_ms_per_call=host, max_abs_err=err, ms_verify_chunk=vms,
                ms_warm_l2_verify_chunk=statistics.median(vwarm))


def time_lookup_tiers(res, k, keys, split_key_bits, flush_buf):
    """fused_lookup with the run and the delta populated, over the
    read-back batches of the inserted keys: against plain on the first
    (bit-equal), then timed launch by launch like ``time_lookup`` and
    bounded by the sectors its reads touch, the tier searches' included.
    """
    dev = torch.device("cuda")
    nfl = res["nfl"]
    kw = lookup_kw(nfl)
    batches = [lookup_args(nfl, keys[i:i + BATCH], dev, split_key_bits)
               for i in range(0, keys.shape[0], BATCH)]
    if batches[0][5] is None:
        fail(f"{res['name']}: no write tier holds data for the tier timing")
    _pk, zk, err = compare_lookup(res, batches[0], kw, k,
                                  "read-back batch, tiers populated")
    a0 = batches[0]
    sectors, _n, _d = touched_sectors(a0[4], zk, a0[1], a0[2], kw, a0[5])
    b0 = a0[0].shape[0]
    bound = (sectors * SECTOR + b0 * (4 * a0[0].shape[1] + 16)) \
        / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.fused_lookup(*a, **kw) for a in batches]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    t = a0[5].pools
    log(f"fused_lookup with tiers (run {int(t.run_len.item())}, delta "
        f"{int(t.dl_len.item())}): median over {len(fns)} read-back "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; {sectors} distinct sectors on the first; "
        f"bound {bound:.6f} ms")
    return dict(ms_tiers=ms, ms_warm_l2_tiers=ms_warm, bound_ms_tiers=bound,
                host_ms_per_call_tiers=host, max_abs_err_tiers=err)


def compare_streamed(res, args, kw, k, what, fused):
    """streamed_lookup against its plain version on one batch (args as
    ``lookup_args``, the stream pack in place of the tree pools):
    payloads and z bit-equal, and equal to the fused kernel's ``fused``
    (payloads, z)."""
    pk, zk = k.streamed_lookup(*args, **kw)
    pp, zp = k.streamed_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    eq = {"payloads": bit_equal(pk, pp), "z": bit_equal(zk, zp),
          "payloads = fused": bit_equal(pk, fused[0]),
          "z = fused": bit_equal(zk, fused[1])}
    err = max(float((pk - pp).abs().max().item()),
              float((zk - zp).abs().max().item()))
    log(f"streamed_lookup vs plain, {res['name']} ({what}), "
        f"{args[0].shape[0]} queries, window {args[4].window}: bit-equal "
        f"{eq}")
    if not all(eq.values()):
        fail(f"streamed_lookup disagrees with its plain version or the "
             f"fused kernel ({what})")
    return err


def stream_kw(nfl):
    return dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
                use_flow=nfl.use_flow)


def time_streamed(res, k, split_key_bits, flush_buf, look):
    """Phase 5, on the fresh index: streamed_lookup against plain and the
    fused kernel on the first read batch, against the fused kernel on
    all 64, then timed launch by launch over the same 64 batches as
    ``fused_lookup`` (``look``)."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    sp = nfl.index._serving.stream_pack()
    kw = stream_kw(nfl)
    batches = [lookup_args(nfl, b, dev, split_key_bits)
               for b in res["batches"]]
    sargs = [(*a[:4], sp, a[5]) for a in batches]
    err = compare_streamed(res, sargs[0], kw, k, "fresh index",
                           k.fused_lookup(*batches[0], **lookup_kw(nfl)))
    diff = 0
    for a, f in zip(sargs, batches):
        ps, zs_ = k.streamed_lookup(*a, **kw)
        pf, zf = k.fused_lookup(*f, **lookup_kw(nfl))
        diff += int((ps != pf).sum()) + int((zs_.view(torch.int32)
                                             != zf.view(torch.int32)).sum())
    if diff:
        fail(f"streamed_lookup differs from fused_lookup in {diff} outputs")
    a0 = sargs[0]
    _p, z0 = k.streamed_lookup(*a0, **kw)
    sectors, tiles = streamed_sectors(sp, a0[5], z0, a0[1], a0[2])
    ksectors = streamed_kernel_sectors(sp, a0[5], z0, a0[1], a0[2])
    io = BATCH * (4 * a0[0].shape[1] + 8 + 8)
    bound = (sectors * SECTOR + io) / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.streamed_lookup(*a, **kw) for a in sargs]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.streamed_lookup_plain(*a0, **kw), 3, 1)
    flow = "on" if nfl.use_flow else "off"
    log(f"streamed_lookup flow={flow}: median over {len(fns)} distinct "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; plain {plain_ms:.3f} ms; scan pool "
        f"{int(sp.pool.plen.item())} rows (capacity {sp.pool.pk.shape[0]}, "
        f"router {sp.router.shape[0]}, window {sp.window}); "
        f"{tiles:.3f} tiles probed/query; {sectors} distinct sectors "
        f"({sectors / BATCH:.3f}/query; the kernel's own reads touch "
        f"{ksectors}, {ksectors / BATCH:.3f}/query); bound {bound:.6f} ms; same "
        f"batches, fused_lookup {look['ms']:.5f} ms cold, "
        f"{look['ms_warm_l2']:.5f} ms warm: streamed/fused "
        f"{ms / look['ms']:.2f} cold, {ms_warm / look['ms_warm_l2']:.2f} "
        "warm")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, ms_warm_l2=ms_warm,
                host_ms_per_call=host, max_abs_err=err,
                tiles_per_query=tiles, sectors=sectors,
                sectors_kernel=ksectors, fused_ms=look["ms"],
                fused_ms_warm_l2=look["ms_warm_l2"],
                streamed_over_fused=ms / look["ms"])


def time_streamed_tiers(res, k, keys, split_key_bits, flush_buf, look_tiers):
    """streamed_lookup with the run and the delta populated, over the
    read-back batches of ``time_lookup_tiers``: against plain (bit-equal)
    and the fused kernel (payloads and z) on the first, then timed launch
    by launch beside the fused kernel's time on the same batches."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    sp = nfl.index._serving.stream_pack()
    kw = stream_kw(nfl)
    batches = [lookup_args(nfl, keys[i:i + BATCH], dev, split_key_bits)
               for i in range(0, keys.shape[0], BATCH)]
    sargs = [(*a[:4], sp, a[5]) for a in batches]
    err = compare_streamed(res, sargs[0], kw, k,
                           "read-back batch, tiers populated",
                           k.fused_lookup(*batches[0], **lookup_kw(nfl)))
    a0 = sargs[0]
    _p, z0 = k.streamed_lookup(*a0, **kw)
    sectors, _tiles = streamed_sectors(sp, a0[5], z0, a0[1], a0[2])
    ksectors = streamed_kernel_sectors(sp, a0[5], z0, a0[1], a0[2])
    b0 = a0[0].shape[0]
    bound = (sectors * SECTOR + b0 * (4 * a0[0].shape[1] + 16)) \
        / HBM_BYTES_PER_S * 1e3
    cold, warm, host = timed_launches(
        [lambda a=a: k.streamed_lookup(*a, **kw) for a in sargs], flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    fms = look_tiers["ms_tiers"]
    log(f"streamed_lookup with tiers: median over {len(sargs)} read-back "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; {sectors} distinct sectors on the first (the "
        f"kernel's own reads {ksectors}); bound {bound:.6f} ms; same "
        f"batches, fused_lookup {fms:.5f} ms cold: streamed/fused "
        f"{ms / fms:.2f}")
    return dict(ms_tiers=ms, ms_warm_l2_tiers=ms_warm, bound_ms_tiers=bound,
                host_ms_per_call_tiers=host, sectors_kernel_tiers=ksectors,
                fused_ms_tiers=fms, streamed_over_fused_tiers=ms / fms,
                max_abs_err_tiers=err)


def time_probe(res, k, probe_args, flush_buf):
    """Phase 5: index_probe against plain on all 64 root-probe batches of
    s1 (bit-equal), timed launch by launch over them and bounded by the
    sectors its gathers touch plus its inputs and outputs."""
    want = [k.index_probe_plain(*a) for a in probe_args]
    got = [k.index_probe(*a) for a in probe_args]
    torch.cuda.synchronize()
    eq = all(bit_equal(g, w) for gs, ws in zip(got, want)
             for g, w in zip(gs, ws))
    err = max(float((g - w).abs().max().item())
              for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    log(f"index_probe vs plain, {res['name']} root node, "
        f"{len(probe_args)} batches of {BATCH}: payload, code and child "
        f"bit-equal {eq}")
    if not eq:
        fail("index_probe disagrees with its plain version")
    a0 = probe_args[0]
    sectors = probe_sectors(*a0[:5], a0[5:])
    ksectors = probe_sectors(*a0[:5], a0[5:], kernel=True)
    io = BATCH * (12 + 12)
    bound = (sectors * SECTOR + io) / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.index_probe(*a) for a in probe_args]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.index_probe_plain(*a0), 5, 1)
    log(f"index_probe: median over {len(fns)} distinct batches {ms:.5f} ms "
        f"cold L2 (min {min(cold):.5f}, max {max(cold):.5f}), "
        f"{ms_warm:.5f} ms warm L2; host issue {host:.5f} ms/call; plain "
        f"{plain_ms:.3f} ms; {sectors} distinct sectors + {io} B of inputs "
        f"and outputs (the kernel's own gathers touch {ksectors}); bound "
        f"{bound:.6f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, ms_warm_l2=ms_warm,
                host_ms_per_call=host, max_abs_err=err,
                sectors_kernel=ksectors)


def compare_lookup_tiers(res, k, split_key_bits):
    """fused_lookup and streamed_lookup against their plain versions (and
    each other) while the run and the delta hold data and tombstones: a
    batch of deleted, updated, inserted, loaded and unloaded keys, also
    held to the ground truth."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    rng = np.random.default_rng(res["seed"] + 300)
    parts = [res["deleted"], res["truth"].keys, res["unloaded"]]
    if "updated" in res:
        parts.append(res["updated"][0])
    keys = np.concatenate([rng.choice(p, BATCH // len(parts))
                           for p in parts])
    args = lookup_args(nfl, keys, dev, split_key_bits)
    if args[5] is None:
        fail(f"{res['name']}: no write tier holds data for the comparison")
    what = "run and delta populated, tombstones"
    pk, zk, err = compare_lookup(res, args, lookup_kw(nfl), k, what)
    wrong = int((pk.cpu().numpy() != res["truth"].lookup(keys)).sum())
    log(f"fused_lookup with populated tiers against ground truth: "
        f"wrong={wrong}")
    if wrong:
        fail(f"{res['name']}: fused_lookup wrong with populated tiers")
    sargs = (*args[:4], nfl.index._serving.stream_pack(), args[5])
    err_s = compare_streamed(res, sargs, stream_kw(nfl), k, what, (pk, zk))
    return err, err_s


def compare_range(res, args, k):
    """fused_range_scan against plain on one batch: pv, cnt, tot, zlo,
    zhi bit-equal, and zlo equal to nf_forward's z with the flow on."""
    nfl = res["nfl"]
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes, scan_cap=SCAN_CAP,
              use_flow=nfl.use_flow)
    got = k.fused_range_scan(*args, **kw)
    want = k.fused_range_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    eq = {n: bit_equal(g, w) for n, g, w in
          zip(("pv", "cnt", "tot", "zlo", "zhi"), got, want)}
    err = max(float((g.to(torch.float64) - w.to(torch.float64))
                    .abs().max().item()) for g, w in zip(got, want))
    tp = args[4]
    log(f"fused_range_scan vs plain, {res['name']} "
        f"(flow {'on' if nfl.use_flow else 'off'}; run "
        f"{int(tp.pools.run_len.item()) if tp else 0}, delta "
        f"{int(tp.pools.dl_len.item()) if tp else 0}), "
        f"{args[0].shape[0]} ranges: bit-equal {eq}")
    if not all(eq.values()):
        fail("fused_range_scan disagrees with its plain version")
    if nfl.use_flow:
        zf = k.nf_forward(args[0], nfl._packed_w, nfl._shapes,
                          nfl.cfg.flow.dim)
        if not bit_equal(got[3], zf):
            fail("range kernel zlo differs from nf_forward z")
        log("fused_range_scan zlo equals nf_forward z bit for bit: True")
    return got, err, kw


def time_range(res, batches, k, flush_buf):
    """The range kernel over its distinct batches, each launch timed
    alone, cold and warm, with its bound from the sectors it must read
    plus its inputs and output rows."""
    _got, err, kw = compare_range(res, batches[0], k)
    got = [k.fused_range_scan(*a, **kw) for a in batches]
    sectors, probe = [], []
    for a, g in zip(batches, got):
        s, p = range_sectors(a[3], a[4], g[3], g[4], SCAN_CAP)
        sectors.append(s)
        probe.append(p)
    b = batches[0][0].shape[0]
    io = b * (2 * 4 * batches[0][0].shape[1] + (SCAN_CAP + 4) * 4)
    bounds = [(s * SECTOR + io) / HBM_BYTES_PER_S * 1e3 for s in sectors]
    fns = [lambda a=a: k.fused_range_scan(*a, **kw) for a in batches]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    bound = statistics.median(bounds)
    plain_ms = time_ms(lambda: k.fused_range_scan_plain(*batches[0], **kw),
                       2, 1)
    rows = sum(int(g[1].sum().item()) for g in got) / len(got)
    log(f"fused_range_scan flow={'on' if kw['use_flow'] else 'off'}: "
        f"median over {len(fns)} distinct batches of {b} ranges "
        f"{ms:.5f} ms cold L2 (min {min(cold):.5f}, max {max(cold):.5f}), "
        f"{ms_warm:.5f} ms warm L2; host issue {host:.5f} ms/call; plain "
        f"{plain_ms:.3f} ms; {rows:.0f} rows/batch; bound {bound:.6f} ms "
        f"(median {statistics.median(sectors):.0f} sectors of searches, "
        f"spans and probe windows + {io} B of inputs and output rows; the "
        f"probes' own binary searches touch {statistics.median(probe):.0f} "
        f"more, not counted); ms/bound {ms / bound:.1f} cold, "
        f"{ms_warm / bound:.1f} warm")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                ms_warm_l2=ms_warm, host_ms_per_call=host, max_abs_err=err,
                ratio_to_bound=ms / bound)


# ------------------------------------------------------- LM serving path
def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at |x|."""
    return 2.0 ** (int(np.floor(np.log2(max(abs(x), 2.0 ** -126)))) - 7)


def lm_serve(win, seed):
    """Phase 6: falcon-mamba-7b at full width and depth, random weights on
    the card, 16 requests through the continuous batcher until drained,
    in one counted window."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                             ServeConfig)

    # f32 products and convolutions in full f32 for the f32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    base = get_config(LM_ARCH)
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, use_scan_kernel=True))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {cfg.param_dtype}; {n_params} parameters "
        f"({sum(t.numel() * t.element_size() for t in leaves(params)) / 2**30:.2f} "
        f"GiB) drawn in {init_s:.2f} s")
    rng = np.random.default_rng(seed + 400)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    pre_s, dec_ms, bad = [], [], collections.Counter()

    def prefill(p, tokens, max_len):
        t = time.perf_counter()
        state, logits = model.prefill(p, tokens, max_len)
        bad["prefill"] += int((~torch.isfinite(logits)).sum())
        pre_s.append(time.perf_counter() - t)
        return state, logits

    def decode_step(p, state, tokens):
        t = time.perf_counter()
        logits, state = model.decode_step(p, state, tokens)
        bad["decode"] += int((~torch.isfinite(logits)).sum())
        dec_ms.append((time.perf_counter() - t) * 1e3)
        return logits, state

    timed = dataclasses.replace(model, prefill=prefill,
                                decode_step=decode_step)
    batcher = ContinuousBatcher(timed, params, ServeConfig(
        batch_slots=LM_SLOTS, max_len=LM_PROMPT[1] + LM_NEW))
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=LM_NEW)
            for i, pr in enumerate(prompts)]

    def drive():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for r in reqs:
            batcher.submit(r)
        status = batcher.run_until_drained()
        return status, t, time.perf_counter() - t

    (status, t_sub, secs), counts = win.run(drive)
    n_prompt = int(lens.sum())
    n_new = sum(len(r.output) for r in reqs)
    ttft = [(r.t_first - t_sub) * 1e3 for r in reqs]
    met = dict(
        init_s=init_s, params=n_params, requests=len(reqs),
        prompt_tokens=n_prompt, new_tokens=n_new, decode_steps=batcher.steps,
        seconds=secs, prefill_tokens_per_s=n_prompt / sum(pre_s),
        prefill_ms_median=statistics.median(pre_s) * 1e3,
        prefill_ms_max=max(pre_s) * 1e3,
        ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
        decode_step_ms_median=statistics.median(dec_ms),
        decode_step_ms_max=max(dec_ms),
        decode_tokens_per_s=n_new / secs,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[lm] served {len(reqs)} requests ({n_prompt} prompt tokens, "
        f"{n_new} new) in {secs:.2f} s, {batcher.steps} decode steps of "
        f"{LM_SLOTS} slots: prefill {met['prefill_tokens_per_s']:.0f} "
        f"tokens/s (ms per request median {met['prefill_ms_median']:.1f}, "
        f"max {met['prefill_ms_max']:.1f}); TTFT ms median "
        f"{met['ttft_ms_median']:.1f} max {met['ttft_ms_max']:.1f}; decode "
        f"step ms median {met['decode_step_ms_median']:.2f} max "
        f"{met['decode_step_ms_max']:.2f}; {met['decode_tokens_per_s']:.1f} "
        f"new tokens/s end to end; peak {met['peak_gib']:.2f} GiB; "
        f"non-finite logits {dict(bad)}; launches {counts}")
    log("[lm] metrics " + json.dumps(met))
    if not status.drained or any(len(r.output) != LM_NEW or not r.done
                                 for r in reqs):
        fail("lm: a request did not finish with its tokens")
    if sum(bad.values()):
        fail(f"lm: non-finite logits {dict(bad)}")
    if len(pre_s) != LM_REQUESTS \
            or counts["mamba_scan"] != cfg.n_layers * len(pre_s):
        fail(f"lm: mamba_scan launched {counts['mamba_scan']} times for "
             f"{len(pre_s)} prefills of {cfg.n_layers} layers")
    if counts["flash_decode"]:
        fail("lm: flash_decode launched on the ssm path")
    return dict(model=model, params=params, cfg=cfg, reqs=reqs, met=met,
                max_len=LM_PROMPT[1] + LM_NEW)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def lm_replay(lm):
    """Teacher-forced: replay the batcher's tokens of ``LM_REPLAYS``
    requests through a batch-1 prefill and decode loop; each token must
    score within 4 bf16 ulps of the replay's maximum logit (a batch of 8
    and a batch of 1 round apart in the products, so argmax may differ
    only on a near tie)."""
    model, params = lm["model"], lm["params"]
    dev = torch.device("cuda")
    worst = (0.0, 0.0)
    flips = 0
    for r in lm["reqs"][:LM_REPLAYS]:
        toks = torch.as_tensor(r.prompt[None].astype(np.int64), device=dev)
        state, logits = model.prefill(params, toks, lm["max_len"])
        for t, tok in enumerate(r.output):
            if t:
                logits, state = model.decode_step(
                    params, state, torch.tensor([[r.output[t - 1]]],
                                                device=dev))
            lg = logits[0].float()
            mx = float(lg.max())
            gap = mx - float(lg[tok])
            flips += int(gap > 0)
            if gap > 4 * bf16_ulp(mx):
                fail(f"lm replay: request {r.rid} token {t} ({tok}) scores "
                     f"{gap} below the replay's max logit {mx}")
            if gap >= worst[0]:
                worst = (gap, 4 * bf16_ulp(mx))
    log(f"[lm] teacher-forced replay of {LM_REPLAYS} requests x {LM_NEW} "
        f"tokens at batch 1: {flips} tokens not the replay's argmax; worst "
        f"gap to the max logit {worst[0]} (bound {worst[1]})")
    return dict(flips=flips, worst_gap=worst[0])


def decode_profile(lm):
    """One decode step of ``LM_SLOTS`` slots under ``torch.profiler``: the
    device operations it launches and their summed device time, beside
    the step's host wall time.  Informational: where the profiler sees no
    device events, the counts read "not measured" and nothing fails."""
    from torch.profiler import ProfilerActivity, profile

    model, params = lm["model"], lm["params"]
    dev = torch.device("cuda")
    state = model.init_decode_state(LM_SLOTS, lm["max_len"])
    tokens = torch.zeros((LM_SLOTS, 1), dtype=torch.long, device=dev)
    for _ in range(2):
        _lg, state = model.decode_step(params, state, tokens)
    torch.cuda.synchronize()
    out = dict(device_ops=None, device_ms=None, wall_ms=None)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            model.decode_step(params, state, tokens)
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - t) * 1e3
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:          # informational: never fails the smoke
        log(f"[lm] decode step profile: not measured ({exc!r})")
        return out
    if evs:
        out["device_ops"] = len(evs)
        out["device_ms"] = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    log(f"[lm] decode step of {LM_SLOTS} slots under torch.profiler: "
        f"{out['device_ops'] if evs else 'not measured'} device operations "
        f"(kernels, copies, fills), summed device time "
        f"{out['device_ms'] if evs else 'not measured'} ms, host wall "
        f"{out['wall_ms']:.3f} ms with the profiler on (unprofiled step "
        f"median {lm['met']['decode_step_ms_median']:.3f} ms)")
    return out


def lm_branches(lm, seed):
    """The kernel path against the chunked path on one prompt of 2,048
    tokens: one mamba_block in f32 with layer 0's weights, and the full
    model's bf16 prefill logits.  Returns the scan inputs of the first
    ``LM_SCAN_LAYERS`` layers on that prompt (for phase 7)."""
    from repro_torch.models import ssm, transformer as tfm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import build_model

    dev = torch.device("cuda")
    model, params, cfg = lm["model"], lm["params"], lm["cfg"]
    chunked = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, use_scan_kernel=False))
    rng = np.random.default_rng(seed + 401)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, LM_CHECK_LEN)),
                           device=dev)
    lp0 = tfm.layer_params(params, 0)
    p32 = {k: v.float() for k, v in lp0["ssm"].items()}
    h = rms_norm(params["embed"][toks].float(), lp0["ln"].float(),
                 cfg.norm_eps)
    yk = ssm.mamba_block(h, p32, cfg.d_model, cfg.ssm)
    yc = ssm.mamba_block(h, p32, cfg.d_model, chunked.ssm)
    err = float((yk - yc).abs().max())
    ok = bool(torch.allclose(yk, yc, rtol=BRANCH_TOL, atol=BRANCH_TOL))
    log(f"[lm] mamba_block layer 0 in f32, {LM_CHECK_LEN} tokens: kernel vs "
        f"chunked max |dy| {err} (max |y| {float(yc.abs().max())}); within "
        f"{BRANCH_TOL}: {ok}")
    if not ok:
        fail("lm: kernel and chunked mamba_block disagree in f32")
    del yk, yc, h, p32
    t = time.perf_counter()
    _, lk = model.prefill(params, toks, lm["max_len"])
    torch.cuda.synchronize()
    tk = time.perf_counter() - t
    t = time.perf_counter()
    _, lc = build_model(chunked).prefill(params, toks, lm["max_len"])
    torch.cuda.synchronize()
    tc = time.perf_counter() - t
    lk, lc = lk[0].float(), lc[0].float()
    rel = float((lk - lc).norm() / lc.norm())
    top = torch.topk(lc, 2).values
    same = int(lk.argmax()) == int(lc.argmax())
    log(f"[lm] full-model bf16 prefill logits, {LM_CHECK_LEN} tokens: "
        f"kernel vs chunked relative L2 {rel} (bound {LM_LOGIT_REL_L2}), "
        f"max |d| {float((lk - lc).abs().max())}, same argmax {same} "
        f"(chunked top-2 gap {float(top[0] - top[1])}); prefill s kernel "
        f"{tk:.3f}, chunked {tc:.3f}")
    if not rel < LM_LOGIT_REL_L2 or not same:
        fail("lm: kernel and chunked prefill logits disagree")
    caps = []
    x = params["embed"][toks]
    for i in range(LM_SCAN_LAYERS):
        lp = tfm.layer_params(params, i)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        caps.append((*ssm.mamba_scan_inputs(h, lp["ssm"])[:4],
                     lp["ssm"]["A_log"].contiguous()))
        x = tfm._ssm_block(x, lp, cfg)
    return caps, dict(block_err=err, logit_rel_l2=rel, same_argmax=same,
                      prefill_s_kernel=tk, prefill_s_chunked=tc)


def sm_rates():
    """(FP32 issue slots, SFU results) per second: SMs x 128 and SMs x 16
    per clock, at the max SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_PER_SM_PER_CLOCK * hz, sms * SFU_PER_SM_PER_CLOCK * hz


def sfu_per_s() -> float:
    """exp2 results per second: SMs x 16 per clock x the max SM clock."""
    return sm_rates()[1]


def scan_row(caps, k, flush_buf):
    """Phase 7: mamba_scan against plain on layer 0's real inputs and on
    their first 1,000 positions, timed launch by launch over the captured
    layers, bounded by its bytes or its exponentials."""
    ragged = tuple(t[:, :1000].contiguous() if t.dim() == 3 else t
                   for t in caps[0])
    err = 0.0
    for what, args in (("layer 0", caps[0]), ("layer 0, L 1000", ragged)):
        yk = k.mamba_scan(*args)
        yp = k.mamba_scan_plain(*args)
        torch.cuda.synchronize()
        e = float((yk - yp).abs().max())
        same = float((yk == yp).float().mean())
        ok = bool(torch.allclose(yk, yp, rtol=SCAN_TOL, atol=SCAN_TOL))
        log(f"mamba_scan vs plain, {what} {tuple(args[0].shape)} N "
            f"{args[2].shape[2]}: max |dy| {e}, bit-equal share {same}, "
            f"within {SCAN_TOL}: {ok}")
        if not ok or not bool(torch.isfinite(yk).all()):
            fail(f"mamba_scan disagrees with its plain version ({what})")
        err = max(err, e)
    b, l, di = caps[0][0].shape
    n = caps[0][2].shape[2]
    bytes_ = b * l * di * 4 * 3 + b * l * n * 4 * 2 + di * n * 4
    exps = b * l * di * n
    rate = sfu_per_s()
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = exps / rate * 1e3
    plan = k.scan_plan(b, l, di, n)
    log(f"mamba_scan plan at {(b, l, di, n)}: {plan._asdict()}")
    fns = [lambda a=a: k.mamba_scan(*a) for a in caps]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.mamba_scan_plain(*caps[0]), 1, 1)
    bound = max(t_bytes, t_ops)
    log(f"mamba_scan: median over {len(fns)} layers' inputs {ms:.5f} ms "
        f"cold L2 (min {min(cold):.5f}, max {max(cold):.5f}), {ms_warm:.5f} "
        f"ms warm L2; host issue {host:.5f} ms/call; plain {plain_ms:.3f} "
        f"ms; bytes {bytes_} -> {t_bytes:.5f} ms, {exps} exponentials at "
        f"{rate:.4g}/s -> {t_ops:.5f} ms; ms/bound {ms / bound:.1f}")
    return {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:67",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "ms_warm_l2": ms_warm, "host_ms_per_call": host,
        "bytes_ms": t_bytes, "exp_ms": t_ops, "sfu_per_s": rate,
        "shape": [b, l, di, n], "plan": plan._asdict()}


def flash_decode_inputs(seed):
    from repro_torch.configs import get_config

    a = get_config(FD_ATTN_ARCH).attn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 500)
    q = torch.randn(FD_BATCH, a.n_heads, a.head_dim, generator=g,
                    device=dev) / a.head_dim ** 0.5
    kc = torch.randn(FD_BATCH, FD_SEQ, a.kv_heads, a.head_dim, generator=g,
                     device=dev, dtype=torch.bfloat16)
    vc = torch.randn(FD_BATCH, FD_SEQ, a.kv_heads, a.head_dim, generator=g,
                     device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(seed + 501)
    kv_len = rng.integers(1, FD_SEQ + 1, FD_BATCH)
    kv_len[:3] = (0, 1, FD_SEQ)
    return q, kc, vc, kv_len


def flash_decode_window(win, ops, q, kc, vc, kv_len):
    """Phase 6: ``ops.flash_decode`` through its entry point, one call per
    decode step with each row's length one longer (capped at S), in a
    counted window; each output finite, the empty row 0."""
    dev = q.device

    def drive():
        outs = []
        for step in range(FD_STEPS):
            kl = np.minimum(kv_len + step * (kv_len > 0), FD_SEQ)
            outs.append(ops.flash_decode(q, kc, vc, torch.as_tensor(
                kl, dtype=torch.int32, device=dev)))
        torch.cuda.synchronize()
        return outs

    outs, counts = win.run(drive)
    ok = all(bool(torch.isfinite(o).all()) and not o[0].any() for o in outs)
    log(f"[decode attention] ops.flash_decode over {FD_STEPS} steps, "
        f"{tuple(q.shape)} x cache {tuple(kc.shape)} bf16, lengths "
        f"{kv_len.tolist()}: finite with the empty row 0: {ok}; launches "
        f"{counts}")
    if not ok or counts["flash_decode"] != FD_STEPS:
        fail("flash_decode window: wrong outputs or launches")


def sdpa_ms(q, kc, vc, kl, flush_buf):
    """``scaled_dot_product_attention`` over the same cache (heads-major
    copies, a length mask): the library yardstick, timed only, never
    called by the port.  Returns the mean of 5 calls back to back (the
    host's issue time shows through when the call is short) and the
    median of 16 calls each alone after an L2 flush, timed as the
    kernels are (the figure to hold them against)."""
    import torch.nn.functional as F

    s = kc.shape[1]
    qs = q.to(kc.dtype)[:, :, None, :]
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < kl[:, None].long()
            )[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              scale=1.0, enable_gqa=True)

    mean = time_ms(library, 5, 1)
    cold = statistics.median(launch_times_ms([library] * 16, flush_buf.zero_))
    return mean, cold


def decode_bytes(kc, kv_len, b, h):
    """K and V rows below kv_len, read once, plus q and o in f32."""
    s, kh, d = kc.shape[1:]
    rows = int(np.minimum(kv_len, s).sum())
    return rows, rows * kh * d * kc.element_size() * 2 + 2 * b * h * d * 4


def flash_decode_row(k, flush_buf, q, kc, vc, kv_len):
    """Phase 7: flash_decode against plain with the bf16 cache and an f32
    one, timed launch by launch, bounded by the K/V rows below kv_len
    plus q and o, beside SDPA (timed only); then the same at B 1 over the
    row of length S, where the split plan matters most."""
    dev = q.device
    kl = torch.as_tensor(kv_len, dtype=torch.int32, device=dev)
    b, s, kh, d = kc.shape
    h = q.shape[1]
    err = 0.0
    one = int(np.flatnonzero(kv_len == s)[0])      # the row of length S
    cases = (("bf16 cache", (q, kc, vc, kl)),
             ("f32 cache", (q[:FD_F32_BATCH].contiguous(),
                            kc[:FD_F32_BATCH].float(),
                            vc[:FD_F32_BATCH].float(), kl[:FD_F32_BATCH])),
             ("bf16 cache, B 1", (q[one:one + 1], kc[one:one + 1],
                                  vc[one:one + 1], kl[one:one + 1])))
    for what, args in cases:
        plan = k.device_plan(args[0], args[1])
        ok_k = k.flash_decode(*args, plan)
        ok_p = k.flash_decode_plain(*args, plan)
        torch.cuda.synchronize()
        e = float((ok_k - ok_p).abs().max())
        good = bool(torch.allclose(ok_k, ok_p, rtol=FD_TOL, atol=FD_TOL))
        lens = args[3].tolist()
        zero = all(not ok_k[i].any() and not ok_p[i].any()
                   for i, n in enumerate(lens) if n == 0)
        log(f"flash_decode vs plain, {what} {tuple(args[1].shape)}, "
            f"lengths {lens}, plan {plan._asdict()}: max |do| {e}, within "
            f"{FD_TOL}: {good} (plain's mean |o| "
            f"{float(ok_p.abs().mean())}); kv_len 0 rows zero in both: "
            f"{zero}")
        if not (good and zero):
            fail(f"flash_decode disagrees with its plain version ({what})")
        err = max(err, e)
        del ok_k, ok_p
    if kv_len[0] != 0:
        fail("flash_decode inputs lost their kv_len 0 row")
    plan = k.device_plan(q, kc)
    rows, bytes_ = decode_bytes(kc, kv_len, b, h)
    bound = bytes_ / HBM_BYTES_PER_S * 1e3
    fns = [lambda: k.flash_decode(q, kc, vc, kl)] * 16
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.flash_decode_plain(q, kc, vc, kl), 1, 1)
    lib_ms, lib_cold = sdpa_ms(q, kc, vc, kl, flush_buf)
    log(f"flash_decode: median over {len(fns)} launches {ms:.5f} ms cold L2 "
        f"(min {min(cold):.5f}, max {max(cold):.5f}), {ms_warm:.5f} ms warm "
        f"L2; host issue {host:.5f} ms/call; plain {plain_ms:.3f} ms; SDPA "
        f"{lib_ms:.5f} ms back to back, {lib_cold:.5f} ms cold L2; {rows} "
        f"K/V positions, {bytes_} B -> bound "
        f"{bound:.5f} ms; ms/bound {ms / bound:.2f}; plan {plan._asdict()}")
    a1 = cases[2][1]
    plan1 = k.device_plan(a1[0], a1[1])
    rows1, bytes1 = decode_bytes(kc, kv_len[one:one + 1], 1, h)
    bound1 = bytes1 / HBM_BYTES_PER_S * 1e3
    cold1, warm1, _h1 = timed_launches([lambda: k.flash_decode(*a1)] * 16,
                                       flush_buf)
    ms1 = statistics.median(cold1)
    lib1, lib1_cold = sdpa_ms(*a1, flush_buf)
    log(f"flash_decode at B 1, S {s}: median {ms1:.5f} ms cold L2, "
        f"{statistics.median(warm1):.5f} ms warm; SDPA {lib1:.5f} ms back "
        f"to back, {lib1_cold:.5f} ms cold L2; "
        f"{rows1} positions, {bytes1} B -> bound {bound1:.5f} ms; ms/bound "
        f"{ms1 / bound1:.2f}; plan {plan1._asdict()}")
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:69",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": lib_cold, "library_ms_back_to_back": lib_ms,
        "ms_warm_l2": ms_warm, "host_ms_per_call": host, "positions": rows,
        "shape": [b, h, kh, d, s], "plan": plan._asdict(),
        "b1_ms": ms1, "b1_ms_warm_l2": statistics.median(warm1),
        "b1_library_ms": lib1_cold, "b1_library_ms_back_to_back": lib1,
        "b1_bound_ms": bound1, "b1_plan": plan1._asdict()}


# ----------------------------------------------------------------- main
class Mods:
    """The port's modules the smoke drives (imported after the checks)."""

    def __init__(self):
        from repro_torch.core.nfl import NFL, NFLConfig
        from repro_torch.core.train_flow import FlowTrainConfig
        from repro_torch.data.datasets import make_dataset
        from repro_torch.data.workloads import (WorkloadConfig,
                                                _zipf_indices, make_workload)
        from repro_torch.kernels import ops

        self.NFL, self.NFLConfig = NFL, NFLConfig
        self.FlowTrainConfig = FlowTrainConfig
        self.make_dataset, self.make_workload = make_dataset, make_workload
        self.WorkloadConfig, self.zipf_indices = WorkloadConfig, _zipf_indices
        self.ops = ops


class Kernels:
    def __init__(self):
        from repro_torch.kernels.fused_lookup import (fused_lookup,
                                                      fused_lookup_plain)
        from repro_torch.kernels.index_probe import (index_probe,
                                                     index_probe_plain)
        from repro_torch.kernels.streamed_lookup import (
            streamed_lookup, streamed_lookup_plain)
        from repro_torch.kernels.nf_forward import (nf_forward,
                                                    nf_forward_plain)
        from repro_torch.kernels.range_scan import (fused_range_scan,
                                                    fused_range_scan_plain)

        self.nf_forward, self.nf_forward_plain = nf_forward, nf_forward_plain
        self.fused_lookup = fused_lookup
        self.fused_lookup_plain = fused_lookup_plain
        self.fused_range_scan = fused_range_scan
        self.fused_range_scan_plain = fused_range_scan_plain
        self.streamed_lookup = streamed_lookup
        self.streamed_lookup_plain = streamed_lookup_plain
        self.index_probe, self.index_probe_plain = (index_probe,
                                                    index_probe_plain)
        from repro_torch.kernels.flash_decode import (device_plan,
                                                      flash_decode,
                                                      flash_decode_plain)
        from repro_torch.kernels.mamba_scan import (mamba_scan,
                                                    mamba_scan_plain,
                                                    scan_plan)

        self.mamba_scan, self.mamba_scan_plain = mamba_scan, mamba_scan_plain
        self.scan_plan = scan_plan
        self.flash_decode = flash_decode
        self.flash_decode_plain = flash_decode_plain
        self.device_plan = device_plan


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.flat_afli import split_key_bits
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    phase_build(build)
    m, k = Mods(), Kernels()
    win = Windows(m.ops)
    dev = torch.device("cuda")
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    walls = {}

    def wall(tag, t0):
        walls[tag] = time.perf_counter() - t0
        log(f"phase {tag}: {walls[tag]:.1f} s wall")

    # ---- the contract checker and its fixture kernels
    t0 = time.perf_counter()
    fixture_rows = analysis_phase(flush_buf)
    wall("contract checker", t0)

    # ---- longlat, flow on
    t0 = time.perf_counter()
    ll = bulkload_and_read("longlat", LONGLAT_KEYS, None, 0, m, win)
    if not ll["use_flow"]:
        fail("longlat phase did not serve with the flow on")
    wall("longlat reads", t0)
    look = {True: time_lookup(ll, k, split_key_bits, flush_buf)}
    t0 = time.perf_counter()
    s1 = streamed_reads(ll, win, split_key_bits, "fresh index",
                        {"misses": ll["miss_keys"]})
    probe_args = root_probe(ll, m, win, s1["fused"], split_key_bits)
    wall("longlat streamed reads", t0)
    streamed = {True: time_streamed(ll, k, split_key_bits, flush_buf,
                                    look[True])}
    probe = time_probe(ll, k, probe_args, flush_buf)
    del probe_args, s1
    t0 = time.perf_counter()
    ins_k, _ins_p = write_stream(ll, m, win, N_WRITE_BATCHES, False)
    ins_u = np.unique(ins_k)
    readback(ll, ins_u, win, "inserted keys read back")
    look_tiers = time_lookup_tiers(ll, k, ins_u, split_key_bits, flush_buf)
    streamed_tiers = time_streamed_tiers(ll, k, ins_u, split_key_bits,
                                         flush_buf, look_tiers)
    rows = {"nf_forward": nf_forward_row(ll, k, flush_buf,
                                         ll.pop("write_batches"))}
    update_and_delete(ll, win, ins_k)
    wall("longlat writes", t0)
    t0 = time.perf_counter()
    readback(ll, ins_u, win, "inserted keys read back", streamed=True)
    readback(ll, ll["updated"][0], win, "updated keys", streamed=True)
    readback(ll, ll["deleted"], win, "deleted keys", streamed=True)
    wall("longlat streamed readback", t0)
    del ins_u
    t0 = time.perf_counter()
    sk, zs, ps = scan_truth(ll, m, dev)
    queries = scan_queries(ll, m, sk, N_SCAN_BATCHES)
    ll["scan"] = run_scans(ll, win, sk, zs, ps, queries, "YCSB E")
    wall("longlat scans", t0)
    err_tiers = {True: compare_lookup_tiers(ll, k, split_key_bits)}
    ranged = {True: time_range(ll, scan_args(ll["nfl"], sk, queries, dev),
                               k, flush_buf)}
    t0 = time.perf_counter()
    idx = ll["nfl"].index
    router_builds = idx._serving.router_builds
    (_none, counts) = win.run(idx.rebuild)
    log(f"[longlat] rebuild(): {time.perf_counter() - t0:.2f} s, fold "
        f"{idx.last_fold}; n_rebuilds {idx.n_rebuilds}; run "
        f"{idx.stats()['run_len']}; launches {counts}")
    if idx.n_rebuilds < 1 or idx.stats()["run_len"] != idx.n_shadowed:
        fail("longlat: rebuild did not fold the tiers")
    readback(ll, np.concatenate(ll["batches"]), win,
             "read batches after rebuild (updates and deletes applied)")
    readback(ll, ll["deleted"], win, "deleted keys after rebuild")
    run_scans(ll, win, sk, zs, ps, queries[:1], "after rebuild")
    streamed_reads(ll, win, split_key_bits, "after rebuild",
                   {"deleted keys": ll["deleted"]})
    built = idx._serving.router_builds - router_builds
    log(f"[longlat] router builds across rebuild(): {built}")
    if built != 1:
        fail(f"longlat: the router was built {built} times for the folded "
             "scan pool (expected once)")
    wall("longlat rebuild", t0)
    log(f"[longlat] max_memory_allocated since its bulkload "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del sk, zs, ps

    # ---- lognormal, flow off
    t0 = time.perf_counter()
    ln = bulkload_and_read("lognormal", LOGNORMAL_KEYS, False, 1, m, win)
    look[False] = time_lookup(ln, k, split_key_bits, flush_buf)
    streamed[False] = time_streamed(ln, k, split_key_bits, flush_buf,
                                    look[False])
    ins_k, _ = write_stream(ln, m, win, MAX_FOLD_BATCHES, True,
                            alternate=True)
    readback(ln, np.unique(ins_k), win, "inserted keys read back")
    dele = np.random.default_rng(301).choice(ln["truth"].keys, TAIL,
                                             replace=False)

    def tail_delete():
        return ln["nfl"].delete_batch(dele), ln["nfl"].lookup_batch(dele)

    (ok, got), _c = win.run(tail_delete)
    ln["truth"].delete(dele)
    ln["deleted"] = dele
    st = ln["nfl"].index.stats()
    log(f"[lognormal] {TAIL} deletes: n_keys {st['n_keys']} (truth "
        f"{ln['truth'].keys.shape[0]}); run {st['run_len']} delta "
        f"{st['delta_len']}")
    if not ok.all() or (got != -1).any() \
            or st["n_keys"] != ln["truth"].keys.shape[0]:
        fail("lognormal: wrong tail deletes")
    if not (st["run_len"] and st["delta_len"]):
        fail("lognormal: the tiers do not both hold data before the scans")
    sk, zs, ps = scan_truth(ln, m, dev)
    queries = scan_queries(ln, m, sk, 1)
    ln["scan"] = run_scans(ln, win, sk, zs, ps, queries, "YCSB E")
    err_tiers[False] = compare_lookup_tiers(ln, k, split_key_bits)
    _g, err_off, _kw = compare_range(ln, scan_args(ln["nfl"], sk, queries,
                                                   dev)[0], k)
    wall("lognormal", t0)
    log(f"[lognormal] max_memory_allocated since its bulkload "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del flush_buf

    # ---- sharded serving: the single indexes' tensors go first
    del ln, idx, sk, zs, ps, queries, ll["nfl"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = sharded_phase(ll, m, win, split_key_bits, dev)
    wall("sharded", t0)

    # ---- LM serving: the index phases' tensors go first
    del ll
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = lm_serve(win, 0)
    lm["replay"] = lm_replay(lm)
    lm["decode_profile"] = decode_profile(lm)
    caps, lm["branches"] = lm_branches(lm, 0)
    del lm["model"], lm["params"]
    gc.collect()
    torch.cuda.empty_cache()
    fd_in = flash_decode_inputs(0)
    flash_decode_window(win, m.ops, *fd_in)
    wall("lm serving and decode attention", t0)
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    lm_rows = {"mamba_scan": scan_row(caps, k, flush_buf)}
    del caps
    lm_rows["flash_decode"] = flash_decode_row(k, flush_buf, *fd_in)
    del fd_in, flush_buf
    log("[lm] summary " + json.dumps({key: lm[key] for key in
                                      ("met", "replay", "decode_profile",
                                       "branches")}))
    log("[sharded] summary " + json.dumps(sharded, default=str))

    launches = dict(win.total)
    log(f"main-path launches (every window): {launches}")
    lookup_sizes = size_buckets(win.lookup_sizes)
    log(f"fused_lookup main-path launches by batch size: {lookup_sizes} "
        f"(exact sizes: {len(win.lookup_sizes)} distinct; "
        f"{win.lookup_sizes.get(BATCH, 0)} of {BATCH}, "
        f"{win.lookup_sizes.get(VERIFY_CHUNK, 0)} of {VERIFY_CHUNK})")
    nf_sizes = size_buckets(win.nf_sizes)
    log(f"nf_forward main-path launches by batch size: {nf_sizes} (exact "
        f"sizes: {dict(sorted(win.nf_sizes.items()))})")
    rows["nf_forward"]["launches_by_batch"] = nf_sizes
    on, off = look[True], look[False]
    rows["fused_lookup"] = {
        "name": "fused_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_lookup.cu",
        "replaces": "src/repro/kernels/fused_lookup.py:490",
        "launches": None,
        "max_abs_err": max(on["max_abs_err"], off["max_abs_err"],
                           look_tiers["max_abs_err_tiers"],
                           *(e[0] for e in err_tiers.values())),
        "ms": on["ms"], "plain_ms": on["plain_ms"],
        "bound_ms": on["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "ms_warm_l2": on["ms_warm_l2"],
        "host_ms_per_call": on["host_ms_per_call"],
        "ms_verify_chunk": on["ms_verify_chunk"],
        "ms_warm_l2_verify_chunk": on["ms_warm_l2_verify_chunk"],
        **{key: v for key, v in look_tiers.items() if key.endswith("tiers")
           and not key.startswith("max_abs_err")},
        "launches_by_batch": lookup_sizes,
        **{f"{key}_flow_off": v for key, v in off.items()
           if key != "max_abs_err"},
    }
    rs = ranged[True]
    rows["fused_range_scan"] = {
        "name": "fused_range_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/range_scan.cu",
        "replaces": "src/repro/kernels/range_scan.py:232",
        "launches": None, "max_abs_err": max(rs["max_abs_err"], err_off),
        "ms": rs["ms"], "plain_ms": rs["plain_ms"],
        "bound_ms": rs["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "ms_warm_l2": rs["ms_warm_l2"],
        "host_ms_per_call": rs["host_ms_per_call"],
        "ratio_to_bound": rs["ratio_to_bound"],
    }
    son, soff = streamed[True], streamed[False]
    rows["streamed_lookup"] = {
        "name": "streamed_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streamed_lookup.cu",
        "replaces": "src/repro/kernels/streamed_lookup.py:283",
        "launches": None,
        "max_abs_err": max(son["max_abs_err"], soff["max_abs_err"],
                           streamed_tiers["max_abs_err_tiers"],
                           *(e[1] for e in err_tiers.values())),
        "ms": son["ms"], "plain_ms": son["plain_ms"],
        "bound_ms": son["bound_ms"], "bound_by": "bytes", "library_ms": None,
        **{key: v for key, v in son.items()
           if key not in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
        **{key: v for key, v in streamed_tiers.items()
           if key != "max_abs_err_tiers"},
        **{f"{key}_flow_off": v for key, v in soff.items()
           if key != "max_abs_err"},
    }
    log("streamed/fused kernel time, cold L2: longlat (flow on) "
        f"{son['streamed_over_fused']:.3f} fresh, "
        f"{streamed_tiers['streamed_over_fused_tiers']:.3f} with tiers; "
        f"lognormal (flow off) {soff['streamed_over_fused']:.3f} fresh")
    rows["index_probe"] = {
        "name": "index_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/index_probe.cu",
        "replaces": "src/repro/kernels/index_probe.py:62",
        "launches": None, "max_abs_err": probe["max_abs_err"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_warm_l2": probe["ms_warm_l2"],
        "host_ms_per_call": probe["host_ms_per_call"],
        "sectors_kernel": probe["sectors_kernel"],
    }
    rows.update(lm_rows)
    rows.update(fixture_rows)
    # the fixture kernels' main path is the checker's self-test (phase 1b)
    launches.update({name: row["launches"]
                     for name, row in fixture_rows.items()})
    out = []
    for row in rows.values():
        row["launches"] = launches.get(row["name"], 0)
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched on the main path")
        out.append(row)
    log(f"phase walls: {walls}")
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
