"""Drive repro_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero before the result lines):

1. device: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. main path, launch counters zeroed just before and read just after:
   ``longlat`` at 2^25 keys, half (2^24) bulk-loaded through
   ``NFL(NFLConfig(backend="flat"))`` with the default flow and training
   configs and AutoSwitch deciding (rerun with ``force_flow=True`` if it
   declines the flow, so the in-kernel NF serves); the paper's read-only
   workload (zipf 0.99) in 64 batches of 65,536 plus one batch of
   unloaded keys, every payload checked against ground truth; then
   ``lognormal`` at 2^22 keys with ``force_flow=False`` (the kernel's
   no-flow variant).
3. kernels against their plain PyTorch versions on the card at the main
   path's shapes, with times, bounds and the library yardstick.  The
   fused lookup is timed launch by launch over the 64 distinct read
   batches, each launch after an L2 flush (cold) or after an idle spin
   (warm L2), so the events bracket device time only; its host cost per
   call is reported apart.  Its bound counts the distinct 32-byte
   sectors the batch's reads touch.
4. result lines: the kernel table as JSON, then the final JSON object
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or when the
repository's sources are missing.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM f32, outside the tensor cores
SECTOR = 32                    # bytes per device-memory sector
BATCH = 65536
N_READ_BATCHES = 64
LONGLAT_KEYS = 1 << 25         # half bulk-loaded
LOGNORMAL_KEYS = 1 << 22
L2_FLUSH_BYTES = 512 << 20     # ten times the H100's 50 MB L2
SPIN_CYCLES = 400_000          # ~0.2 ms idle spin, longer than a host call


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
    if tiers is not None:
        t = tiers.pools
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        for tag, iters, window in (("run", tiers.run_iters, tiers.run_window),
                                   ("dl", tiers.delta_iters,
                                    tiers.delta_window)):
            read(f"{tag}_len", zero)
            n = int(getattr(t, f"{tag}_len").item())
            if n <= 0:
                continue
            pk, hi, lo, pv = (getattr(t, f"{tag}_{f}")
                              for f in ("pk", "hi", "lo", "pv"))
            l = torch.zeros_like(q, dtype=torch.int64)
            h = torch.full_like(l, n)
            for _ in range(iters):
                mid = (l + h) // 2
                m = torch.clamp(mid, max=pk.shape[0] - 1)
                read(f"{tag}_pk", m)
                go = pk[m] < q
                l, h = torch.where(go, mid + 1, l), torch.where(go, h, mid)
            j = (l - window)[:, None] + torch.arange(4 * window, device=dev)
            inside = (j >= 0) & (j < n)
            jc = torch.clamp(j, 0, n - 1)
            th = inside & (hi[jc] == qhi[:, None])
            tl = th & (lo[jc] == qlo[:, None])
            read(f"{tag}_hi", j[inside])
            read(f"{tag}_lo", j[th])
            hit = tl.any(dim=1)
            lastj = torch.max(torch.where(tl, j, -1), dim=1).values
            read(f"{tag}_pv", lastj[hit])
    per_sector = SECTOR // 4                   # every pool is 4-byte
    sectors = sum(int(torch.unique(torch.cat(v) // per_sector).numel())
                  for v in reads.values())
    n_reads = sum(int(x.numel()) for v in reads.values() for x in v)
    return sectors, n_reads, levels / q.shape[0]


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


class Phase:
    """One main-path run: data, bulkload, reads, misses."""

    def __init__(self, name, n_keys, force_flow, seed):
        self.name, self.n_keys, self.force_flow = name, n_keys, force_flow
        self.seed = seed


def run_main_path(ph: Phase, mods, results: dict) -> dict:
    NFL, NFLConfig, make_dataset, make_workload, WorkloadConfig, ops = mods
    t0 = time.perf_counter()
    keys = make_dataset(ph.name, ph.n_keys)
    wl = make_workload(keys, WorkloadConfig(
        mix="read_only", n_ops=N_READ_BATCHES * BATCH, batch_size=BATCH,
        zipf_s=0.99, seed=ph.seed))
    unloaded = np.setdiff1d(keys, wl.load_keys, assume_unique=True)
    miss_keys = np.random.default_rng(ph.seed).choice(unloaded, BATCH,
                                                      replace=False)
    log(f"[{ph.name}] {keys.shape[0]} keys, {wl.load_keys.shape[0]} "
        f"bulk-loaded; data {time.perf_counter() - t0:.1f} s")

    def bulkload(force):
        torch.cuda.reset_peak_memory_stats()
        nfl = NFL(NFLConfig(backend="flat", force_flow=force))
        t = time.perf_counter()
        nfl.bulkload(wl.load_keys, wl.load_payloads)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    ops.reset_launch_counts()
    nfl, t_bulk = bulkload(ph.force_flow)
    if ph.force_flow is None and not nfl.use_flow:
        log(f"[{ph.name}] AutoSwitch declined the flow (tails "
            f"{nfl.metrics['tail_conflict_original']:.0f} -> "
            f"{nfl.metrics['tail_conflict_transformed']:.0f}); "
            "rerunning with force_flow=True")
        ops.reset_launch_counts()
        nfl, t_bulk = bulkload(True)
    m = nfl.metrics
    log(f"[{ph.name}] use_flow={nfl.use_flow} tail_conflict "
        f"original={m['tail_conflict_original']:.0f} "
        f"transformed={m['tail_conflict_transformed']:.0f} "
        f"shadowed={nfl.dispatch_stats()['shadowed']}")
    log(f"[{ph.name}] bulkload {t_bulk:.2f} s = train "
        f"{m['flow_train_s']:.2f} s ({m['flow_n_steps']:.0f} steps) + "
        f"transform {m['transform_s']:.2f} s + build "
        f"{m['index_build_s']:.2f} s (+ AutoSwitch and packing)")

    wrong = 0
    n_reads = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _op, k, p in wl.batches:
        got = nfl.lookup_batch(k)
        wrong += int((got != p).sum())
        n_reads += k.shape[0]
    t_reads = time.perf_counter() - t
    got = nfl.lookup_batch(miss_keys)
    wrong_miss = int((got != -1).sum())
    counts = ops.launch_counts()
    stats = nfl.index.stats()
    pool_bytes = stats["serving"]["pool_bytes"]
    log(f"[{ph.name}] reads: {n_reads} in {N_READ_BATCHES} batches, "
        f"wrong={wrong}; misses: {BATCH} unloaded keys, wrong={wrong_miss}")
    log(f"[{ph.name}] lookups/s end to end (host feature expansion, copies, "
        f"kernel): {n_reads / t_reads:.0f}")
    log(f"[{ph.name}] launches: {counts}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; pool bytes "
        f"{pool_bytes} ({stats['n_nodes']} nodes, {stats['n_entries']} "
        f"entries, {stats['n_buckets']} buckets, depth {stats['max_depth']})")
    if wrong or wrong_miss:
        fail(f"{ph.name}: {wrong} wrong reads, {wrong_miss} wrong misses")
    if counts["fused_lookup"] == 0:
        fail(f"{ph.name}: fused_lookup never launched on the main path")
    if nfl.use_flow and counts["nf_forward"] == 0:
        fail(f"{ph.name}: nf_forward never launched on the main path")
    results[ph.name] = {"nfl": nfl, "keys": wl.load_keys, "counts": counts,
                        "batches": [k for _op, k, _p in wl.batches],
                        "use_flow": nfl.use_flow}
    return results[ph.name]


def compare_kernels(res_flow, res_noflow, mods_k) -> list:
    (nf_forward, nf_forward_plain, fused_lookup, fused_lookup_plain,
     expand_features, split_key_bits) = mods_k
    dev = torch.device("cuda")
    rows = []

    # ---- nf_forward on the bulk-load keys
    nfl = res_flow["nfl"]
    cfg = nfl.cfg.flow
    feats = torch.from_numpy(expand_features(
        res_flow["keys"], nfl.normalizer, cfg.dim, cfg.theta,
        dtype=np.float32)).to(dev)
    packed, shapes = nfl._packed_w, nfl._shapes
    zk = nf_forward(feats, packed, shapes, cfg.dim)
    zp = nf_forward_plain(feats, packed, shapes, cfg.dim)
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
    # per key: standardize (sub, mul), a multiply and an add per weight,
    # one op per tanh, the decode's d multiplies and d-1 adds
    flops = (2 * d + sum(2 * o * n for o, n in shapes)
             + sum(o for o, _ in shapes[:-1]) + 2 * d - 1)
    bytes_ = b * (4 * d + 4)
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, b * flops / F32_FLOPS_PER_S) * 1e3
    rows.append({
        "name": "nf_forward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nf_forward.cu",
        "replaces": "src/repro/kernels/nf_forward.py:113",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(lambda: nf_forward(feats, packed, shapes, d), 20),
        "plain_ms": time_ms(lambda: nf_forward_plain(feats, packed, shapes,
                                                     d), 5, 1),
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                     >= b * flops / F32_FLOPS_PER_S else "operations"),
        "library_ms": time_ms(library, 5, 1),
    })
    del feats, zk, zp

    # ---- fused_lookup on the read batches, flow on and off
    max_err = 0.0
    fused_rows = {}
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for res in (res_flow, res_noflow):
        nfl = res["nfl"]
        idx = nfl.index
        flow = "on" if nfl.use_flow else "off"

        def device_args(keys):
            hi, lo = split_key_bits(keys)
            if nfl.use_flow:
                f = expand_features(keys, nfl.normalizer, nfl.cfg.flow.dim,
                                    nfl.cfg.flow.theta, dtype=np.float32)
            else:
                f = keys.astype(np.float32).reshape(-1, 1)
            return (torch.from_numpy(f).to(dev),
                    torch.from_numpy(hi.view(np.int32)).to(dev),
                    torch.from_numpy(lo.view(np.int32)).to(dev),
                    nfl._packed_w, idx._kernel_pools(), idx._tier_pack())

        batches = [device_args(k) for k in res["batches"]]
        args = batches[0]
        kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
                  max_depth=idx.max_depth,
                  dense_iters=idx.cfg.dense_search_iters,
                  bucket_cap=idx.cfg.max_bucket,
                  dense_window=idx.dense_window,
                  use_flow=nfl.use_flow)
        pk, zk = fused_lookup(*args, **kw)
        pp, zp = fused_lookup_plain(*args, **kw)
        torch.cuda.synchronize()
        pay_eq = bool(torch.equal(pk, pp))
        z_eq = bool(torch.equal(zk.view(torch.int32), zp.view(torch.int32)))
        err = max(float((pk - pp).abs().max().item()),
                  float((zk - zp).abs().max().item()))
        max_err = max(max_err, err)
        log(f"fused_lookup vs plain, flow={flow}, {BATCH} queries: payloads "
            f"bit-equal {pay_eq}, z bit-equal {z_eq}")
        if not (pay_eq and z_eq):
            fail("fused_lookup disagrees with its plain version")
        if nfl.use_flow:
            zf = nf_forward(args[0], nfl._packed_w, nfl._shapes,
                            nfl.cfg.flow.dim)
            same = bool(torch.equal(zk.view(torch.int32),
                                    zf.view(torch.int32)))
            log(f"fused_lookup z equals nf_forward z bit for bit: {same}")
            if not same:
                fail("in-kernel NF z differs from nf_forward z")

        sectors, n_reads, mean_depth = touched_sectors(
            args[4], zk, args[1], args[2], kw, args[5])
        io = BATCH * (4 * args[0].shape[1] + 8 + 8)
        bound = (sectors * SECTOR + io) / HBM_BYTES_PER_S * 1e3
        fns = [lambda a=a: fused_lookup(*a, **kw) for a in batches]
        for fn in fns[:4]:
            fn()
        cold = launch_times_ms(fns, flush_buf.zero_)
        warm = launch_times_ms(fns, lambda: torch.cuda._sleep(SPIN_CYCLES))
        host = host_ms_per_call(fns)
        ms, ms_warm = statistics.median(cold), statistics.median(warm)
        plain_ms = time_ms(lambda: fused_lookup_plain(*args, **kw), 3, 1)
        log(f"fused_lookup flow={flow}: median over {len(fns)} distinct "
            f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
            f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
            f"{host:.5f} ms/call; plain {plain_ms:.3f} ms; mean depth "
            f"{mean_depth:.3f}; {n_reads / BATCH:.2f} reads/query in "
            f"{sectors} distinct sectors ({sectors / BATCH:.3f}/query); "
            f"bound {bound:.6f} ms")
        fused_rows[nfl.use_flow] = dict(ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound, ms_warm_l2=ms_warm,
                                        host_ms_per_call=host)
        del batches, fns, args
    del flush_buf
    on, off = fused_rows[True], fused_rows[False]
    rows.append({
        "name": "fused_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_lookup.cu",
        "replaces": "src/repro/kernels/fused_lookup.py:490",
        "launches": None, "max_abs_err": max_err, "ms": on["ms"],
        "plain_ms": on["plain_ms"], "bound_ms": on["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "ms_warm_l2": on["ms_warm_l2"],
        "host_ms_per_call": on["host_ms_per_call"],
        **{f"{k}_flow_off": v for k, v in off.items()},
    })
    return rows


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
    from repro_torch.core.feature import expand_features
    from repro_torch.core.flat_afli import split_key_bits
    from repro_torch.core.nfl import NFL, NFLConfig
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.workloads import WorkloadConfig, make_workload
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.fused_lookup import (fused_lookup,
                                                  fused_lookup_plain)
    from repro_torch.kernels.nf_forward import nf_forward, nf_forward_plain

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    phase_build(build)

    mods = (NFL, NFLConfig, make_dataset, make_workload, WorkloadConfig, ops)
    results: dict = {}
    res_flow = run_main_path(Phase("longlat", LONGLAT_KEYS, None, 0), mods,
                             results)
    if not res_flow["use_flow"]:
        fail("longlat phase did not serve with the flow on")
    res_noflow = run_main_path(Phase("lognormal", LOGNORMAL_KEYS, False, 1), mods,
                               results)
    launches = {k: res_flow["counts"][k] + res_noflow["counts"][k]
                for k in res_flow["counts"]}
    log(f"main-path launches (both phases): {launches}")

    rows = compare_kernels(res_flow, res_noflow, (
        nf_forward, nf_forward_plain, fused_lookup, fused_lookup_plain,
        expand_features, split_key_bits))
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched on the main path")
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
