"""Timing of the NF, point-read, range and node-probe kernels across
source trees, and of sharded read batches on one card.

    python3 src/repro_torch/kernel_ab.py run --tree LABEL=ROOT
            [--tree LABEL=ROOT ...] [--variants LABEL] [--kernels K ...]
            [--rounds 2] [--shard-rounds N] [--read-rounds N]

Each ``ROOT`` is the root of a checkout of the port (``src/repro_torch``).
One process prepares the inputs the way ``chip_smoke.py`` makes them,
at the sizes below, serving through the first tree's package:
``longlat`` at 2^25 keys, half bulk-loaded with the default configs
(flow on), the 64 zipf read batches of 65,536 on the fresh index, 16
chunks of 4,096 loaded keys in key order (the size of ``rebuild()``'s
verify chunks), the bulk load's 2^24 keys' features and those of the
inserts of each of the 64 ``write_heavy`` batches, the read-back of the
inserted keys in batches of 65,536 with the run and the delta populated,
the updates and deletes, and the 16 YCSB-E scan batches of 16,384
ranges; then ``lognormal`` at 2^22 keys, half loaded, flow off, and its
64 read batches; the scan pool and its router as each index holds them;
for ``index_probe``, the longlat root node and each read batch's z from
the fused rung (the smoke's root probe).  It makes only what the chosen
``--kernels`` time, and saves it under ``build/kernel_ab/``.  Then every tree times
``fused_lookup`` (fresh flow on and off, verify chunk, tiered),
``streamed_lookup`` (the same fresh and tiered batches), ``nf_forward``
(2^24 keys, the write batches), ``fused_range_scan`` and ``index_probe``
through its own wrappers (``--kernels`` picks some), each in a process of its own, in
turns (``a b ... b a`` for two rounds), every launch timed alone behind
an L2 flush (cold) or an idle spin (warm), as ``chip_smoke.py`` times
them.  Each side first checks its kernels against its plain versions on
one batch of each case (variants skip that check).

``--variants LABEL`` adds builds of that tree's sources with one part of
a kernel cut out or changed, to show where the time goes (``VARIANTS``:
the patches are written against one version of the sources, and the
tree's label names that version; a variant times only the kernels whose
sources it patches).  ``final`` holds PR 18's point and range kernels'
variants (see its comments); ``pr18`` cuts parts out of PR 18's
streamed kernel (its
router reads, its tile search, its tiers, all but z) and the first NF
kernel (all but its loads and stores); ``hopper`` does the same for the
redesigned ones and tries other block sizes and guess counts of their
searches, the router in device memory, the NF one key a thread, and the
node probe reading all five entry arrays in one round; ``pr19`` times the floor of the probe timing (an empty launch, a copy of
24 bytes a query) and the one-query-a-thread probe without its entry
reads.

``--shard-rounds N`` also builds a 4-shard index on the longlat keys'
own z and flow in the preparing process and times its 64 read batches
end to end with a CUDA stream per shard and with every shard on one
stream, in turns (``AB-SHARDS``).

``--read-rounds N`` times the single index's read call on the same 64
batches (features made beforehand), host ms from the call to its
payloads on the host, in turns (``AB-READS``): ``async``, the port's
``FlatAFLI.lookup_batch_flow`` (uploads without a stream sync, the
payloads copied into pinned memory behind an event); ``sync``, the same
launch with the payloads brought back by a blocking ``.cpu()``; and
``parent``, the parent's read call copied here (blocking uploads, the
payloads and z brought back by ``.cpu()``).

Prints one ``AB {...}`` JSON line per side and a summary line per case
and tree: the median of the per-process medians.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# kernel -> (its library, the cases it is timed on)
CASES = {
    "fused_lookup": ("fused_lookup",
                     ("fresh", "fresh_off", "verify_chunk", "tiered")),
    "streamed_lookup": ("streamed_lookup",
                        ("s_fresh", "s_fresh_off", "s_tiered")),
    "nf_forward": ("nf_forward", ("nf_full", "nf_batch")),
    "fused_range_scan": ("range_scan", ("range",)),
    "index_probe": ("index_probe", ("probe",)),
}
KERNELS = tuple(CASES)
WORK = ROOT / "build" / "kernel_ab"
N_VERIFY_CHUNKS = 16
VERIFY_CHUNK = 4096
# the load and write trace these timings have always used, larger than
# the smoke's own since the smoke was cut to fit its time limit
LONGLAT_KEYS = 1 << 25
N_WRITE_BATCHES = 64

# per tree label, per variant: (file under kernels/csrc, text, replacement)
VARIANTS = {
    # the first streamed and NF kernels (one thread per query or key,
    # the router and the tiles through __ldg, the weights staged per
    # block): parts cut out
    "pr18": {
        # no router reads: each query probes one pseudo-random tile
        "no_router": [
            ("streamed_lookup.cu", "  int l = 0, h = n_tiles;",
             "  int l = 0, h = 0;"),
            ("streamed_lookup.cu",
             "  int result = -1;\n  for (int t = l - 1; t >= 0; --t) {\n",
             "  l = 1 + (int)(((unsigned)i * 2654435761u) %\n"
             "                (unsigned)max(n_tiles, 1));\n"
             "  int result = -1;\n  for (int t = l - 1; t >= 0; --t) {\n"
             "    if (t < l - 1) break;\n"),
        ],
        # the tile's search stops at row 0: the window is read there
        "no_tile_search": [
            ("streamed_lookup.cu",
             "rows, TILE_ITERS, a.window, q, qhi,",
             "rows, 0, a.window, q, qhi,"),
        ],
        "no_tiers": [
            ("streamed_lookup.cu", "  if (a.probe_tiers) {\n    const int dl",
             "  if (0) {\n    const int dl"),
        ],
        # z alone: the NF (or the key), then the store
        "nf_only": [
            ("streamed_lookup.cu", "  const int qhi = __ldg(a.qhi + i);\n",
             "  a.out_pay[i] = -1;\n  a.out_z[i] = q;\n  return;\n"
             "  const int qhi = __ldg(a.qhi + i);\n"),
        ],
        # the NF kernel's loads and stores without the flow
        "nf_copy": [
            ("nf_forward.cu", "  out[i] = nf_eval<MAXW>(x, p, sw);",
             "  out[i] = x[0] + x[MAXW - 1];"),
        ],
    },
    # the redesigned streamed and NF kernels (router in shared memory,
    # block searches placed by interpolation, the tiers probed beside the
    # pool; the NF unrolled for the default flow, four keys a thread):
    # parts cut out, and other block sizes, guess counts, the router's
    # place and the NF layout
    "hopper": {
        # z alone (with tiers the prober half still probes them)
        "no_pool_probe": [
            ("streamed_lookup.cu",
             "        result = pool_probe(a, s_router, staged, plen, "
             "n_tiles, q, qhi, qlo);",
             "        result = -1;"),
        ],
        "no_tile_search": [
            ("streamed_lookup.cu",
             "    int lb = Isearch::search(a.spk + base, live, q, rt(t), "
             "next);",
             "    int lb = 0;"),
        ],
        "no_tiers": [
            ("streamed_lookup.cu",
             "  if (a->B <= 0) return 0;\n  cudaStream_t s",
             "  a->probe_tiers = 0;\n  if (a->B <= 0) return 0;\n"
             "  cudaStream_t s"),
        ],
        # the router read from device memory, as the first kernel did
        "router_global": [
            ("streamed_lookup.cu", "    staged = min(n_tiles + 1, a.r_smem);",
             "    staged = 0;"),
        ],
        "rows_16": [("tier_device.cuh", "#define ISEARCH_ROWS 8",
                     "#define ISEARCH_ROWS 16")],
        "bisect": [("tier_device.cuh", "#define ISEARCH_GUESSES 4",
                    "#define ISEARCH_GUESSES 0")],
        "guesses_2": [("tier_device.cuh", "#define ISEARCH_GUESSES 4",
                       "#define ISEARCH_GUESSES 2")],
        "guesses_8": [("tier_device.cuh", "#define ISEARCH_GUESSES 4",
                       "#define ISEARCH_GUESSES 8")],
        # interpolate in tier brackets of 1,024 rows or less / of any width
        "narrow_1024": [("tier_device.cuh", "#define ISEARCH_NARROW 4096",
                         "#define ISEARCH_NARROW 1024")],
        "narrow_all": [("tier_device.cuh", "#define ISEARCH_NARROW 4096",
                        "#define ISEARCH_NARROW (1 << 30)")],
        # the NF kernel's loads and stores without the flow
        "nf_copy": [
            ("nf_forward.cu",
             "    z.x = nf_eval<NF_DEFAULT>(x0, p);\n"
             "    z.y = nf_eval<NF_DEFAULT>(x1, p);\n"
             "    z.z = nf_eval<NF_DEFAULT>(x2, p);\n"
             "    z.w = nf_eval<NF_DEFAULT>(x3, p);",
             "    z.x = x0[0] + x0[1];\n    z.y = x1[0] + x1[1];\n"
             "    z.z = x2[0] + x2[1];\n    z.w = x3[0] + x3[1];"),
        ],
        # one key a thread, scalar loads (the default flow unrolled)
        "nf_scalar": [
            ("nf_forward.cu", "  if (kind == NF_DEFAULT && reinterpret_cast",
             "  if (false && kind == NF_DEFAULT && reinterpret_cast"),
        ],
        # the node probe: all five entry arrays read at every slot in one
        # round (the payload gate dropped)
        "probe_all_five": [
            ("index_probe.cu",
             "  int pay = -1;\n  if (code == ET_DATA) {",
             "  int pay = -1;\n  {"),
            ("index_probe.cu",
             "    if (hi == qhi && lo == qlo) pay = pv;",
             "    if (code == ET_DATA && hi == qhi && lo == qlo) pay = pv;"),
        ],
    },
    # the one-query-a-thread node probe (PR 15): the floor this timing
    # can reach (an empty launch; 24 bytes a query copied), and the
    # parent with its entry reads cut out (the key round and the stores)
    "pr19": {
        "probe_empty": [
            ("index_probe.cu",
             "  if (i >= a.B) return;\n",
             "  if (i >= 0) return;\n"),
        ],
        "probe_copy24": [
            ("index_probe.cu",
             "  int slot = __float2int_rz(",
             "  a.out_pay[i] = __float_as_int(q);\n"
             "  a.out_code[i] = __ldg(a.qhi + i);\n"
             "  a.out_child[i] = __ldg(a.qlo + i);\n"
             "  return;\n"
             "  int slot = __float2int_rz("),
        ],
        "probe_no_entries": [
            ("index_probe.cu",
             "  const int et = __ldg(a.etype + slot);",
             "  const int et = slot & 3;"),
            ("index_probe.cu",
             "  if (et == ET_DATA && __ldg(a.ehi + slot) == __ldg(a.qhi + i) &&\n"
             "      __ldg(a.elo + slot) == __ldg(a.qlo + i)) {\n"
             "    pay = __ldg(a.epay + slot);\n"
             "  }",
             "  if (et == ET_DATA) pay = slot;"),
            ("index_probe.cu",
             "  a.out_child[i] = __ldg(a.echild + slot);",
             "  a.out_child[i] = slot;"),
        ],
    },
    # PR 18's point and range kernels: parts cut out
    "final": {
        "no_tiers": [
            ("fused_lookup.cu",
             "  if (a->B <= 0) return 0;\n  const int per_block",
             "  LookupArgs b_ = *a;\n  b_.probe_tiers = 0;\n  a = &b_;\n"
             "  if (a->B <= 0) return 0;\n  const int per_block"),
        ],
        "no_windows": [
            ("fused_lookup.cu",
             "  const int dv = window_pv(a.dhi, a.dlo, a.dpv, dn, "
             "a.dl_window, dl, qhi,\n                           qlo);",
             "  const int dv = -1;"),
            ("fused_lookup.cu",
             "  const int rv = window_pv(a.rhi, a.rlo, a.rpv, rn, "
             "a.run_window, rl, qhi,\n                           qlo);",
             "  const int rv = -1;"),
            ("range_scan.cu",
             "const bool newer_d = me.pool > 0 && a.probe_tiers;",
             "const bool newer_d = false;"),
            ("range_scan.cu",
             "const bool newer_r = me.pool == 2 && a.probe_tiers;",
             "const bool newer_r = false;"),
        ],
        "no_walk": [
            ("fused_lookup.cu",
             "for (int depth = 0; depth < a.max_depth; ++depth) {",
             "for (int depth = 0; depth < 0; ++depth) {"),
        ],
        # the range kernel held to 32 registers a thread (8 blocks an SM)
        "range_32_regs": [
            ("range_scan.cu", "__global__ void __launch_bounds__(WARPS * 32)",
             "__global__ void __launch_bounds__(WARPS * 32, 8)"),
        ],
    },
}


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def prepare(out: Path, tree: str, kernels=KERNELS,
            shard_rounds: int = 0, read_rounds: int = 0) -> None:
    """Make and save the inputs of ``kernels``' cases (CUDA tensors),
    serving through ``tree``'s package; with ``shard_rounds``, also time
    the sharded read batches (``shard_streams``), with ``read_rounds``
    the single index's read call (``read_calls``)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(tree) / "src"))
    cs = _smoke()
    from repro_torch.core.flat_afli import split_key_bits

    class Win(cs.Windows):
        """The smoke's launch windows, on any tree's counters."""

        def run(self, fn, streamed=False):
            self.ops.reset_launch_counts()
            res = fn()
            counts = self.ops.launch_counts()
            counts["scan_truncated"] = self.ops.fused_range_scan.truncated
            return res, counts

    need = set(kernels)
    points = bool(need & {"fused_lookup", "streamed_lookup"})
    m = cs.Mods()
    win = Win(m.ops)
    dev = torch.device("cuda")
    ll = cs.bulkload_and_read("longlat", LONGLAT_KEYS, None, 0, m, win)
    nfl = ll["nfl"]
    if not nfl.use_flow:
        raise SystemExit("longlat did not serve with the flow on")

    def lookups(keys_list):
        out_ = []
        for k in keys_list:
            a = cs.lookup_args(nfl, k, dev, split_key_bits)
            out_.append((a[0], a[1], a[2]))
        return out_

    def stream_pack(n):
        sp = n.index._serving.stream_pack()
        return ([t.clone() for t in sp.pool], sp.router.clone(), sp.window)

    save = {"kw": cs.lookup_kw(nfl), "packed_w": nfl._packed_w,
            "skw": cs.stream_kw(nfl), "stats": {}}
    if points:
        save["pools"] = list(nfl.index._kernel_pools())
        save["stream"] = stream_pack(nfl)
        save["fresh"] = lookups(ll["batches"])
        srt = np.sort(ll["wl"].load_keys)
        step = srt.shape[0] // N_VERIFY_CHUNKS
        save["verify"] = lookups([srt[i * step:i * step + VERIFY_CHUNK]
                                  for i in range(N_VERIFY_CHUNKS)])
    if "index_probe" in need:
        # the smoke's root probe: each read batch's z from the fused rung
        a = nfl.index.arrays
        size = int(a.node_size[0])
        pools = nfl.index._kernel_pools()
        save["probe_node"] = (float(a.node_slope[0]),
                              float(a.node_intercept[0]),
                              [getattr(pools, f)[:size].clone() for f in
                               ("etype", "ehi", "elo", "epayload", "echild")])
        save["probe"] = []
        for k in ll["batches"]:
            _p, z = cs.rung_read(nfl, k, None, split_key_bits)
            hi, lo = split_key_bits(k)
            save["probe"].append(tuple(torch.from_numpy(x).to(dev) for x in
                                       (z, hi.view(np.int32),
                                        lo.view(np.int32))))
    if "nf_forward" in need:
        # the bulk load's transform, and the inserts of each write_heavy
        # batch (NFL._pkeys)
        save["nf_full"] = torch.from_numpy(nfl._feats(ll["wl"].load_keys))
        wl = m.make_workload(ll["keys"], m.WorkloadConfig(
            mix="write_heavy", n_ops=N_WRITE_BATCHES * cs.BATCH,
            batch_size=cs.BATCH, zipf_s=0.99, seed=ll["seed"]))
        save["nf_batch"] = [torch.from_numpy(nfl._feats(k[op != 0]))
                            for op, k, _p in wl.batches]
        save["nf_shape"] = (nfl._shapes, nfl.cfg.flow.dim)
    if shard_rounds:
        save["stats"]["shards"] = shard_streams(cs, m, ll, shard_rounds)
    if read_rounds:
        save["stats"]["reads"] = read_calls(ll, read_rounds)
    if points or "fused_range_scan" in need:
        ins_k, _ = cs.write_stream(ll, m, win, N_WRITE_BATCHES, False)
        ins_u = np.unique(ins_k)
        cs.readback(ll, ins_u, win, "inserted keys read back")
        save["tiered"] = lookups([ins_u[i:i + cs.BATCH]
                                  for i in range(0, ins_u.shape[0],
                                                 cs.BATCH)])
        save["tiered_expect"] = [torch.from_numpy(ll["truth"].lookup(
            ins_u[i:i + cs.BATCH])) for i in range(0, ins_u.shape[0],
                                                   cs.BATCH)]
        tp = nfl.index._tier_pack()
        save["tiers"] = ([t.clone() for t in tp.pools], tp.run_iters,
                         tp.run_window, tp.delta_iters, tp.delta_window)
        if points:
            save["stream_tiered"] = stream_pack(nfl)
        cs.update_and_delete(ll, win, ins_k)
        sk, _zs, _ps = cs.scan_truth(ll, m, dev)
        queries = cs.scan_queries(ll, m, sk, cs.N_SCAN_BATCHES)
        args = cs.scan_args(nfl, sk, queries, dev)
        sp, tp = args[0][3], args[0][4]
        save["scan"] = [(a[0], a[1]) for a in args]
        save["scan_pool"] = (list(sp.pool), sp.iters)
        save["scan_tiers"] = (list(tp.pools), tp.run_iters, tp.run_window,
                              tp.delta_iters, tp.delta_window)
        save["scan_kw"] = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
                               scan_cap=cs.SCAN_CAP, use_flow=nfl.use_flow)
        st = nfl.index.stats()
        save["stats"].update(run_len=st["run_len"],
                             delta_len=st["delta_len"],
                             serving=st["serving"])
    if points:
        ln = cs.bulkload_and_read("lognormal", cs.LOGNORMAL_KEYS, False, 1,
                                  m, win)
        save["kw_off"] = cs.lookup_kw(ln["nfl"])
        save["pools_off"] = list(ln["nfl"].index._kernel_pools())
        save["stream_off"] = stream_pack(ln["nfl"])
        save["skw_off"] = cs.stream_kw(ln["nfl"])
        save["fresh_off"] = [cs.lookup_args(ln["nfl"], k, dev,
                                            split_key_bits)[:3]
                             for k in ln["batches"]]
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(save, out)
    print("AB-PREPARED " + json.dumps(save["stats"], default=str), flush=True)


def shard_streams(cs, m, ll, rounds: int) -> dict:
    """One sharded read batch at a time with one CUDA stream per shard
    against every shard on the current stream, in turns (``per_shard``,
    ``one``, ``one``, ``per_shard``, ...): a ``ShardedFlatAFLI`` of 4
    shards is built on the longlat index's own positioning keys and flow
    (no second training) and serves its 64 read batches through
    ``lookup_batch_flow``, each batch to its result on the host.  Every
    result is checked against the single index's on the first round.
    Returns the median host ms per batch of each mode, per round."""
    import time

    import numpy as np
    import torch

    from repro_torch.core.sharded_nfl import ShardedFlatAFLI

    nfl = ll["nfl"]
    keys, pv = ll["wl"].load_keys, ll["wl"].load_payloads
    z = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, keys,
                                nfl.cfg.flow)
    sh = ShardedFlatAFLI(nfl.cfg.flat_index, n_shards=4)
    sh.build(z, pv, ikeys=keys)
    sh.set_serve_flow(nfl.normalizer, nfl.cfg.flow, nfl._packed_w,
                      nfl._shapes)
    repaired = sh.verify_serve_flow(nfl._feats(keys), keys, nfl._packed_w,
                                    nfl._shapes, pv)
    del z
    batches = ll["batches"]
    feats = [nfl._feats(k) for k in batches]
    want = [nfl.lookup_batch(k) for k in batches]
    streams = list(sh.streams)
    out = {"per_shard": [], "one": [], "repaired": repaired,
           "shard_keys": [s.n_keys for s in sh.shards]}
    for r in range(rounds):
        for mode in (("per_shard", "one") if r % 2 == 0
                     else ("one", "per_shard")):
            sh.streams = streams if mode == "per_shard" else [None] * 4
            ms = []
            for f, k, w in zip(feats, batches, want):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = sh.lookup_batch_flow(f, k, nfl._packed_w, nfl._shapes)
                ms.append((time.perf_counter() - t) * 1e3)
                if r == 0 and not np.array_equal(got, w):
                    raise SystemExit(f"sharded reads ({mode}) differ from "
                                     "the single index's")
            out[mode].append(statistics.median(ms))
    sh.streams = streams
    print("AB-SHARDS " + json.dumps(out), flush=True)
    return out


def read_calls(ll, rounds: int) -> dict:
    """The single index's read call three ways, one batch at a time, in
    turns (``async``, ``sync``, ``parent``, then reversed, ...): the
    median host ms per call of each, per round.  Every result is checked
    against the ground truth on the first round."""
    import time

    import numpy as np
    import torch

    from repro_torch.core.flat_afli import _upload, split_key_bits
    from repro_torch.kernels import ops

    nfl = ll["nfl"]
    idx, pw, shapes = nfl.index, nfl._packed_w, nfl._shapes
    dev = idx.device
    batches = ll["batches"]
    feats = [nfl._feats(k) for k in batches]
    want = [ll["truth"].lookup(k) for k in batches]

    def launch(f, k, up):
        hi, lo = split_key_bits(k)
        pay, z, _path = ops.fused_lookup(
            idx._kernel_pools(), up(f, np.float32), up(hi, np.int32),
            up(lo, np.int32), flow=(pw, shapes), max_depth=idx.max_depth,
            dense_iters=idx.cfg.dense_search_iters,
            bucket_cap=idx.cfg.max_bucket, dense_window=idx.dense_window,
            tiers=idx._tier_pack(), stream=None)
        return pay, z

    def sync(f, k):
        pay, _z = launch(f, k, lambda x, dt: _upload(x, dt, dev))
        return pay.cpu().numpy()

    def parent(f, k):
        # the parent's FlatAFLI._dispatch: uploads by a blocking .to(),
        # payloads and z back by .cpu()
        pay, z = launch(f, k, lambda x, dt: torch.from_numpy(
            np.ascontiguousarray(x).view(np.int32) if x.dtype == np.uint32
            else np.ascontiguousarray(x, dt)).to(dev))
        return pay.cpu().numpy(), z.cpu().numpy()

    modes = {"async": lambda f, k: idx.lookup_batch_flow(f, k, pw, shapes),
             "sync": sync, "parent": lambda f, k: parent(f, k)[0]}
    out = {name: [] for name in modes}
    for r in range(rounds):
        order = list(modes) if r % 2 == 0 else list(modes)[::-1]
        for name in order:
            ms = []
            for f, k, w in zip(feats, batches, want):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = modes[name](f, k)
                ms.append((time.perf_counter() - t) * 1e3)
                if r == 0 and not np.array_equal(got, w):
                    raise SystemExit(f"read call ({name}) is wrong")
            out[name].append(statistics.median(ms))
    print("AB-READS " + json.dumps(out), flush=True)
    return out


def time_side(tree: str, label: str, inputs: Path, check: bool,
              kernels=KERNELS) -> dict:
    """Time one tree's ``kernels`` (names of ``CASES``) on the saved
    inputs."""
    import torch

    sys.path.insert(0, str(Path(tree) / "src"))
    cs = _smoke()
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_lookup import (KernelPools, TierPack,
                                                  TierPools, fused_lookup,
                                                  fused_lookup_plain)
    from repro_torch.kernels.nf_forward import nf_forward, nf_forward_plain
    from repro_torch.kernels.range_scan import (ScanPack, ScanPool,
                                                fused_range_scan,
                                                fused_range_scan_plain)
    from repro_torch.kernels.streamed_lookup import (StreamPack,
                                                     streamed_lookup,
                                                     streamed_lookup_plain)

    info = build.build_all()
    d = torch.load(inputs, map_location="cuda", weights_only=False)
    pw = d["packed_w"].cpu()

    def tiers_of(t):
        return TierPack(TierPools(*t[0]), *t[1:])

    def stream_of(s):
        return StreamPack(ScanPool(*s[0]), s[1], s[2])

    if {"fused_lookup", "streamed_lookup"} & set(kernels):
        pools = KernelPools(*d["pools"])
        tiers = tiers_of(d["tiers"])
        pools_off = KernelPools(*d["pools_off"])
        sp, sp_tiered = stream_of(d["stream"]), stream_of(d["stream_tiered"])
        sp_off = stream_of(d["stream_off"])
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {"label": label, "tree": tree,
           "regs": {n: [ln.strip() for ln in r["log"].splitlines()
                        if "registers" in ln]
                    for n, r in info.items()
                    if any(n == CASES[k][0] for k in kernels)}}

    def timed(name, fns):
        cold, warm, host = cs.timed_launches(fns, flush)
        out[name] = {"ms": statistics.median(cold), "min": min(cold),
                     "max": max(cold), "ms_warm": statistics.median(warm),
                     "host_ms": host, "n": len(fns)}

    def same(got, want):
        return all(cs.bit_equal(g, w) for g, w in zip(got, want))

    if "fused_lookup" in kernels:
        for name, batches, kw in (
                ("fresh", [(f, h, lo_, pw, pools, None)
                           for f, h, lo_ in d["fresh"]], d["kw"]),
                ("fresh_off", [(f, h, lo_, None, pools_off, None)
                               for f, h, lo_ in d["fresh_off"]], d["kw_off"]),
                ("verify_chunk", [(f, h, lo_, pw, pools, None)
                                  for f, h, lo_ in d["verify"]], d["kw"]),
                ("tiered", [(f, h, lo_, pw, pools, tiers)
                            for f, h, lo_ in d["tiered"]], d["kw"])):
            if check:
                if not same(fused_lookup(*batches[0], **kw),
                            fused_lookup_plain(*batches[0], **kw)):
                    raise SystemExit(f"{label}: fused_lookup != plain "
                                     f"({name})")
                if name == "tiered":
                    want = d["tiered_expect"][0].to("cuda", torch.int32)
                    if not torch.equal(fused_lookup(*batches[0], **kw)[0],
                                       want):
                        raise SystemExit(f"{label}: wrong tiered reads")
            timed(name, [lambda a=a, kw=kw: fused_lookup(*a, **kw)
                         for a in batches])
    if "streamed_lookup" in kernels:
        for name, batches, kw in (
                ("s_fresh", [(f, h, lo_, pw, sp, None)
                             for f, h, lo_ in d["fresh"]], d["skw"]),
                ("s_fresh_off", [(f, h, lo_, None, sp_off, None)
                                 for f, h, lo_ in d["fresh_off"]],
                 d["skw_off"]),
                ("s_tiered", [(f, h, lo_, pw, sp_tiered, tiers)
                              for f, h, lo_ in d["tiered"]], d["skw"])):
            if check:
                got = streamed_lookup(*batches[0], **kw)
                if not same(got, streamed_lookup_plain(*batches[0], **kw)):
                    raise SystemExit(f"{label}: streamed_lookup != plain "
                                     f"({name})")
                if name == "s_tiered" and not torch.equal(
                        got[0], d["tiered_expect"][0].to("cuda",
                                                         torch.int32)):
                    raise SystemExit(f"{label}: wrong streamed tiered reads")
            timed(name, [lambda a=a, kw=kw: streamed_lookup(*a, **kw)
                         for a in batches])
    if "nf_forward" in kernels:
        shapes, dim = d["nf_shape"]
        for name, feats in (("nf_full", [d["nf_full"]] * 5),
                            ("nf_batch", d["nf_batch"])):
            if check and not cs.bit_equal(
                    nf_forward(feats[0], pw, shapes, dim),
                    nf_forward_plain(feats[0], pw, shapes, dim)):
                raise SystemExit(f"{label}: nf_forward != plain ({name})")
            timed(name, [lambda f=f: nf_forward(f, pw, shapes, dim)
                         for f in feats])
    if "fused_range_scan" in kernels:
        scan_pack = ScanPack(ScanPool(*d["scan_pool"][0]), d["scan_pool"][1])
        scan_tiers = tiers_of(d["scan_tiers"])
        skw = d["scan_kw"]
        sargs = [(flo, fhi, pw, scan_pack, scan_tiers)
                 for flo, fhi in d["scan"]]
        if check and not same(fused_range_scan(*sargs[0], **skw),
                              fused_range_scan_plain(*sargs[0], **skw)):
            raise SystemExit(f"{label}: fused_range_scan != plain")
        timed("range", [lambda a=a: fused_range_scan(*a, **skw)
                        for a in sargs])
    if "index_probe" in kernels:
        from repro_torch.kernels.index_probe import (index_probe,
                                                     index_probe_plain)
        slope, icpt, entries = d["probe_node"]
        pargs = [(*q, slope, icpt, *entries) for q in d["probe"]]
        if check and not all(same(index_probe(*a), index_probe_plain(*a))
                             for a in pargs):
            raise SystemExit(f"{label}: index_probe != plain")
        timed("probe", [lambda a=a: index_probe(*a) for a in pargs])
    out["checked"] = check
    return out


def make_variant(src_root: Path, label: str, name: str) -> Path:
    """A copy of ``src_root``'s port package with the patches of variant
    ``name`` of the tree labelled ``label``."""
    dst = WORK / f"var_{label}_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src_root / "src" / "repro_torch", dst / "src" /
                    "repro_torch", ignore=shutil.ignore_patterns(
                        "__pycache__"))
    for fname, old, new in VARIANTS[label][name]:
        path = dst / "src" / "repro_torch" / "kernels" / "csrc" / fname
        text = path.read_text()
        if text.count(old) != 1:
            print(f"AB-SKIPPED {label}_{name}: patch text not found once in "
                  f"{fname}", flush=True)
            return None
        path.write_text(text.replace(old, new))
    return dst


def patched_kernels(label: str, name: str) -> tuple:
    """The kernels whose sources (or the headers they include) variant
    ``name`` of ``label`` patches."""
    files = {f for f, _old, _new in VARIANTS[label][name]}
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

    def patched(lib):
        text = (csrc / f"{lib}.cu").read_text()
        return f"{lib}.cu" in files or any(
            f'#include "{f}"' in text for f in files if f.endswith(".cuh"))

    return tuple(k for k, (lib, _cases) in CASES.items() if patched(lib))


def run(args) -> int:
    inputs = WORK / "inputs.pt"
    trees = [t.split("=", 1) for t in args.tree]
    kernels = tuple(args.kernels or KERNELS)
    r = subprocess.run([sys.executable, __file__, "prepare", str(inputs),
                        trees[0][1], "--kernels", *kernels,
                        "--shard-rounds", str(args.shard_rounds),
                        "--read-rounds", str(args.read_rounds)],
                       capture_output=True, text=True)
    sys.stdout.write(r.stdout[-4000:])
    if r.returncode:
        sys.stderr.write(r.stderr[-4000:])
        return r.returncode
    sides = [(label, root, True, kernels) for label, root in trees]
    roots = dict(trees)
    for label in args.variants:
        for name in VARIANTS[label]:
            dst = make_variant(Path(roots[label]), label, name)
            kern = tuple(k for k in patched_kernels(label, name)
                         if k in kernels)
            if dst is not None and kern:
                sides.append((f"{label}_{name}", str(dst), False, kern))
    order = []
    for i in range(args.rounds):
        order += sides if i % 2 == 0 else sides[::-1]
    got, failed = {}, set()
    for label, root, check, kern in order:
        if label in failed:
            continue
        cmd = [sys.executable, __file__, "time", root, label, str(inputs),
               "--kernels", *kern]
        if check:
            cmd.append("--check")
        r = subprocess.run(cmd, capture_output=True, text=True)
        line = next((ln for ln in r.stdout.splitlines()
                     if ln.startswith("AB ")), None)
        if r.returncode or line is None:
            print(f"AB-FAILED {label}: " + (r.stdout[-2000:] + r.stderr[
                -3000:]).replace("\n", "\n  "), flush=True)
            failed.add(label)
            continue
        print(line, flush=True)
        got.setdefault(label, []).append(json.loads(line[3:]))
    for kernel in kernels:
        for case in CASES[kernel][1]:
            print("AB-SUMMARY " + json.dumps({"case": case, **{
                label: {k: statistics.median(s[case][k] for s in runs)
                        for k in ("ms", "ms_warm", "host_ms")}
                for label, runs in got.items() if case in runs[0]}}),
                flush=True)
    inputs.unlink(missing_ok=True)
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run")
    p.add_argument("--tree", action="append", required=True,
                   help="label=root of a checkout")
    p.add_argument("--variants", action="append", default=[],
                   metavar="LABEL", help="also time the variant builds of "
                   "the tree with this label (a key of VARIANTS)")
    p.add_argument("--kernels", nargs="+", choices=KERNELS,
                   help="the kernels the trees time (default: all)")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--shard-rounds", type=int, default=0,
                   help="also time a 4-shard index's read batches with a "
                   "stream per shard and with one, in turns, this many "
                   "rounds (in the preparing process)")
    p.add_argument("--read-rounds", type=int, default=0,
                   help="also time the single index's read call three ways "
                   "in turns, this many rounds (in the preparing process)")
    p = sub.add_parser("prepare")
    p.add_argument("out")
    p.add_argument("tree")
    p.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS)
    p.add_argument("--shard-rounds", type=int, default=0)
    p.add_argument("--read-rounds", type=int, default=0)
    p = sub.add_parser("time")
    p.add_argument("tree")
    p.add_argument("label")
    p.add_argument("inputs")
    p.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS)
    p.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if args.cmd == "prepare":
        prepare(Path(args.out), args.tree, tuple(args.kernels),
                args.shard_rounds, args.read_rounds)
        return 0
    if args.cmd == "time":
        out = time_side(args.tree, args.label, Path(args.inputs), args.check,
                        tuple(args.kernels))
        print("AB " + json.dumps(out), flush=True)
        return 0
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
