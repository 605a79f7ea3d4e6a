"""Timing of the point-read and range kernels across source trees.

    python3 src/repro_torch/kernel_ab.py run --tree LABEL=ROOT
            [--tree LABEL=ROOT ...] [--variants LABEL] [--rounds 2]

Each ``ROOT`` is the root of a checkout of the port (``src/repro_torch``).
One process prepares the inputs the way ``chip_smoke.py`` makes them,
serving through the first tree's package:
``longlat`` at 2^25 keys, half bulk-loaded with the default configs
(flow on), the 64 zipf read batches of 65,536 on the fresh index, 16
chunks of 4,096 loaded keys in key order (the size of ``rebuild()``'s
verify chunks), the 64 ``write_heavy`` batches, the read-back of the
inserted keys in batches of 65,536 with the run and the delta populated,
the updates and deletes, and the 16 YCSB-E scan batches of 16,384
ranges; then ``lognormal`` at 2^22 keys, half loaded, flow off, and its
64 read batches.  It saves them under ``build/kernel_ab/``.  Then every
tree times ``fused_lookup`` (fresh flow on and off, verify chunk,
tiered) and
``fused_range_scan`` through its own wrappers, each in a process of its
own, in turns (``a b ... b a`` for two rounds), every launch timed alone
behind an L2 flush (cold) or an idle spin (warm), as ``chip_smoke.py``
times them.  Each side first checks its kernels against its plain
versions on one batch of each case (variants skip that check).

``--variants LABEL`` adds builds of that tree's sources with one part of
each kernel cut out, to show where the time goes (``VARIANTS``: the
patches are written against one version of the sources, and the tree's
label names that version).  For the first kernels, one thread per query
or range (label ``thread_per_query``): ``no_tier_probes`` (the point
kernel skips the delta and run probes; the range kernel never probes a
candidate), ``no_bucket_loop`` (a conflict bucket matches nothing) and
``window_only`` (every tier probe reads its identity window at row 0
instead of searching).  For the point kernel with a prober half-block
and an entry round of all five fields, and the warp-per-range scan with
one-lane endpoint searches (label ``prober``): ``no_tiers`` (the point
kernel ignores the tiers), ``no_windows`` (no identity window is read,
in either kernel), ``no_search`` (the tier searches stop at row 0),
``no_walk`` (no tree level is read) and ``no_bucket`` (a bucket entry
misses); and three other orders of a level's reads: ``lazy_entry`` (the
entry's type, then the fields its type needs), ``type_child`` (type and
child, then a DATA entry's identity and payload) and ``lazy_node``
(slope and intercept after the dense branch).  For the final kernels
(label ``final``): ``no_tiers``, ``no_windows`` (in the point kernel the
searches' results then go unused, and the compiler drops the searches
too), ``no_walk`` and ``range_32_regs`` (the range kernel held to 32
registers a thread).

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
WORK = ROOT / "build" / "kernel_ab"
N_VERIFY_CHUNKS = 16
VERIFY_CHUNK = 4096

# per tree label, per variant: (file under kernels/csrc, text, replacement)
VARIANTS = {
    # the first kernels: one thread per query or range
    "thread_per_query": {
        "no_tier_probes": [
            ("fused_lookup.cu", "  if (a.probe_tiers) {\n    const int dl",
             "  if (0) {\n    const int dl"),
            ("range_scan.cu", "      superseded = probe_tier(a.dpk",
             "      superseded = 0 && probe_tier(a.dpk"),
            ("range_scan.cu",
             "      if (a.probe_tiers) {\n        superseded =",
             "      if (0) {\n        superseded ="),
        ],
        "no_bucket_loop": [
            ("fused_lookup.cu", "for (int c = 0; c < a.bucket_cap; ++c) {",
             "for (int c = 0; c < 0; ++c) {"),
        ],
        "window_only": [
            ("tier_device.cuh",
             "  const int l = lower_bound(pk, n, cap, iters, q);",
             "  const int l = 0;"),
        ],
    },
    # the point kernel with a prober half-block, its entry round reading
    # all five fields, and the warp-per-range scan with one-lane binary
    # endpoint searches: parts cut out, and three other orders of a
    # level's reads (``type_child`` gives the final point kernel)
    "prober": {
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
        "no_search": [
            ("fused_lookup.cu",
             "  const int iters = a.run_iters > a.dl_iters ? a.run_iters : "
             "a.dl_iters;",
             "  const int iters = 0;"),
        ],
        "no_walk": [
            ("fused_lookup.cu",
             "for (int depth = 0; depth < a.max_depth; ++depth) {",
             "for (int depth = 0; depth < 0; ++depth) {"),
        ],
        "no_bucket": [
            ("fused_lookup.cu", "    if (et == ET_BUCKET) {\n",
             "    if (et == ET_BUCKET) {\n      return -1;\n"),
        ],
        # the entry's type first, then only the fields that type needs
        "lazy_entry": [
            ("fused_lookup.cu",
             "    const int et = __ldg(a.etype + e);\n"
             "    const int eh = __ldg(a.ehi + e);\n"
             "    const int el = __ldg(a.elo + e);\n"
             "    const int ep = __ldg(a.epay + e);\n"
             "    const int ec = __ldg(a.echild + e);\n"
             "    if (et == ET_DATA) return (eh == qhi && el == qlo) ? ep : "
             "-1;\n",
             "    const int et = __ldg(a.etype + e);\n"
             "    if (et == ET_DATA) {\n"
             "      return (__ldg(a.ehi + e) == qhi && __ldg(a.elo + e) == "
             "qlo)\n                 ? __ldg(a.epay + e) : -1;\n    }\n"
             "    const int ec = __ldg(a.echild + e);\n"),
        ],
        # type and child together, then a DATA entry's identity and payload
        "type_child": [
            ("fused_lookup.cu",
             "    const int et = __ldg(a.etype + e);\n"
             "    const int eh = __ldg(a.ehi + e);\n"
             "    const int el = __ldg(a.elo + e);\n"
             "    const int ep = __ldg(a.epay + e);\n"
             "    const int ec = __ldg(a.echild + e);\n"
             "    if (et == ET_DATA) return (eh == qhi && el == qlo) ? ep : "
             "-1;\n",
             "    const int et = __ldg(a.etype + e);\n"
             "    const int ec = __ldg(a.echild + e);\n"
             "    if (et == ET_DATA) {\n"
             "      const int eh = __ldg(a.ehi + e);\n"
             "      const int el = __ldg(a.elo + e);\n"
             "      const int ep = __ldg(a.epay + e);\n"
             "      return (eh == qhi && el == qlo) ? ep : -1;\n    }\n"),
        ],
        # kind, offset and size first; slope and intercept for model nodes
        "lazy_node": [
            ("fused_lookup.cu",
             "    const float slope = __ldg(a.nslope + node);\n"
             "    const float icpt = __ldg(a.nicept + node);\n"
             "    if (kind == KIND_DENSE) {",
             "    if (kind == KIND_DENSE) {"),
            ("fused_lookup.cu", "    int slot = __float2int_rz(",
             "    const float slope = __ldg(a.nslope + node);\n"
             "    const float icpt = __ldg(a.nicept + node);\n"
             "    int slot = __float2int_rz("),
        ],
    },
    # the final kernels: parts cut out
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


def prepare(out: Path, tree: str) -> None:
    """Make and save every case's kernel inputs (CUDA tensors), serving
    through ``tree``'s package."""
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

    m = cs.Mods()
    win = Win(m.ops)
    dev = torch.device("cuda")
    ll = cs.bulkload_and_read("longlat", cs.LONGLAT_KEYS, None, 0, m, win)
    nfl = ll["nfl"]
    if not nfl.use_flow:
        raise SystemExit("longlat did not serve with the flow on")

    def lookups(keys_list):
        out_ = []
        for k in keys_list:
            a = cs.lookup_args(nfl, k, dev, split_key_bits)
            out_.append((a[0], a[1], a[2]))
        return out_

    save = {"kw": cs.lookup_kw(nfl), "packed_w": nfl._packed_w,
            "pools": list(nfl.index._kernel_pools())}
    save["fresh"] = lookups(ll["batches"])
    srt = np.sort(ll["wl"].load_keys)
    step = srt.shape[0] // N_VERIFY_CHUNKS
    save["verify"] = lookups([srt[i * step:i * step + VERIFY_CHUNK]
                              for i in range(N_VERIFY_CHUNKS)])
    ins_k, _ = cs.write_stream(ll, m, win, cs.N_WRITE_BATCHES, False)
    ins_u = np.unique(ins_k)
    cs.readback(ll, ins_u, win, "inserted keys read back")
    save["tiered"] = lookups([ins_u[i:i + cs.BATCH]
                              for i in range(0, ins_u.shape[0], cs.BATCH)])
    save["tiered_expect"] = [torch.from_numpy(ll["truth"].lookup(
        ins_u[i:i + cs.BATCH])) for i in range(0, ins_u.shape[0], cs.BATCH)]
    tp = nfl.index._tier_pack()
    save["tiers"] = ([t.clone() for t in tp.pools], tp.run_iters,
                     tp.run_window, tp.delta_iters, tp.delta_window)
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
    save["stats"] = {"run_len": st["run_len"], "delta_len": st["delta_len"],
                     "serving": st["serving"]}
    ln = cs.bulkload_and_read("lognormal", cs.LOGNORMAL_KEYS, False, 1, m,
                              win)
    save["kw_off"] = cs.lookup_kw(ln["nfl"])
    save["pools_off"] = list(ln["nfl"].index._kernel_pools())
    save["fresh_off"] = [cs.lookup_args(ln["nfl"], k, dev, split_key_bits)[:3]
                         for k in ln["batches"]]
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(save, out)
    print("AB-PREPARED " + json.dumps(save["stats"], default=str), flush=True)


def time_side(tree: str, label: str, inputs: Path, check: bool) -> dict:
    """Time one tree's kernels on the saved inputs."""
    import torch

    sys.path.insert(0, str(Path(tree) / "src"))
    cs = _smoke()
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_lookup import (KernelPools, TierPack,
                                                  TierPools, fused_lookup,
                                                  fused_lookup_plain)
    from repro_torch.kernels.range_scan import (ScanPack, ScanPool,
                                                fused_range_scan,
                                                fused_range_scan_plain)

    info = build.build_all()
    d = torch.load(inputs, map_location="cuda", weights_only=False)
    pools = KernelPools(*d["pools"])
    kw = d["kw"]
    pw = d["packed_w"].cpu()

    def tiers_of(t):
        return TierPack(TierPools(*t[0]), *t[1:])

    tiers = tiers_of(d["tiers"])
    scan_pack = ScanPack(ScanPool(*d["scan_pool"][0]), d["scan_pool"][1])
    scan_tiers = tiers_of(d["scan_tiers"])
    skw = d["scan_kw"]
    pools_off = KernelPools(*d["pools_off"])
    kws = {"fresh_off": d["kw_off"]}
    cases = {
        "fresh": [(f, h, lo_, pw, pools, None) for f, h, lo_ in d["fresh"]],
        "fresh_off": [(f, h, lo_, None, pools_off, None)
                      for f, h, lo_ in d["fresh_off"]],
        "verify_chunk": [(f, h, lo_, pw, pools, None)
                         for f, h, lo_ in d["verify"]],
        "tiered": [(f, h, lo_, pw, pools, tiers)
                   for f, h, lo_ in d["tiered"]],
    }
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {"label": label, "tree": tree,
           "regs": {n: [ln.strip() for ln in r["log"].splitlines()
                        if "registers" in ln]
                    for n, r in info.items()
                    if n in ("fused_lookup", "range_scan")}}
    for name, batches in cases.items():
        kw = kws.get(name, d["kw"])
        if check:
            a = batches[0]
            pk, zk = fused_lookup(*a, **kw)
            pp, zp = fused_lookup_plain(*a, **kw)
            if not (cs.bit_equal(pk, pp) and cs.bit_equal(zk, zp)):
                raise SystemExit(f"{label}: fused_lookup != plain ({name})")
            if name == "tiered":
                want = d["tiered_expect"][0].to(pk.device, torch.int32)
                if not torch.equal(pk, want):
                    raise SystemExit(f"{label}: wrong tiered reads")
        fns = [lambda a=a, kw=kw: fused_lookup(*a, **kw) for a in batches]
        cold, warm, host = cs.timed_launches(fns, flush)
        out[name] = {"ms": statistics.median(cold), "min": min(cold),
                     "max": max(cold), "ms_warm": statistics.median(warm),
                     "host_ms": host, "n": len(fns)}
    sargs = [(flo, fhi, pw, scan_pack, scan_tiers) for flo, fhi in d["scan"]]
    if check:
        got = fused_range_scan(*sargs[0], **skw)
        want = fused_range_scan_plain(*sargs[0], **skw)
        if not all(cs.bit_equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{label}: fused_range_scan != plain")
    fns = [lambda a=a: fused_range_scan(*a, **skw) for a in sargs]
    cold, warm, host = cs.timed_launches(fns, flush)
    out["range"] = {"ms": statistics.median(cold), "min": min(cold),
                    "max": max(cold), "ms_warm": statistics.median(warm),
                    "host_ms": host, "n": len(fns)}
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


def run(args) -> int:
    inputs = WORK / "inputs.pt"
    trees = [t.split("=", 1) for t in args.tree]
    r = subprocess.run([sys.executable, __file__, "prepare", str(inputs),
                        trees[0][1]], capture_output=True, text=True)
    sys.stdout.write(r.stdout[-4000:])
    if r.returncode:
        sys.stderr.write(r.stderr[-4000:])
        return r.returncode
    sides = [(label, root, True) for label, root in trees]
    roots = dict(trees)
    for label in args.variants:
        for name in VARIANTS[label]:
            dst = make_variant(Path(roots[label]), label, name)
            if dst is not None:
                sides.append((f"{label}_{name}", str(dst), False))
    order = []
    for i in range(args.rounds):
        order += sides if i % 2 == 0 else sides[::-1]
    got, failed = {}, set()
    for label, root, check in order:
        if label in failed:
            continue
        cmd = [sys.executable, __file__, "time", root, label, str(inputs)]
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
    for case in ("fresh", "fresh_off", "verify_chunk", "tiered", "range"):
        print("AB-SUMMARY " + json.dumps({"case": case, **{
            label: {k: statistics.median(s[case][k] for s in runs)
                    for k in ("ms", "ms_warm", "host_ms")}
            for label, runs in got.items()}}), flush=True)
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
    p.add_argument("--rounds", type=int, default=2)
    p = sub.add_parser("prepare")
    p.add_argument("out")
    p.add_argument("tree")
    p = sub.add_parser("time")
    p.add_argument("tree")
    p.add_argument("label")
    p.add_argument("inputs")
    p.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if args.cmd == "prepare":
        prepare(Path(args.out), args.tree)
        return 0
    if args.cmd == "time":
        out = time_side(args.tree, args.label, Path(args.inputs), args.check)
        print("AB " + json.dumps(out), flush=True)
        return 0
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
