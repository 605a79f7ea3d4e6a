"""Timing of the NF, point-read and range kernels across source trees.

    python3 src/repro_torch/kernel_ab.py run --tree LABEL=ROOT
            [--tree LABEL=ROOT ...] [--variants LABEL] [--kernels K ...]
            [--rounds 2]

Each ``ROOT`` is the root of a checkout of the port (``src/repro_torch``).
One process prepares the inputs the way ``chip_smoke.py`` makes them,
serving through the first tree's package:
``longlat`` at 2^25 keys, half bulk-loaded with the default configs
(flow on), the 64 zipf read batches of 65,536 on the fresh index, 16
chunks of 4,096 loaded keys in key order (the size of ``rebuild()``'s
verify chunks), the bulk load's 2^24 keys' features and those of the
inserts of each of the 64 ``write_heavy`` batches, the read-back of the
inserted keys in batches of 65,536 with the run and the delta populated,
the updates and deletes, and the 16 YCSB-E scan batches of 16,384
ranges; then ``lognormal`` at 2^22 keys, half loaded, flow off, and its
64 read batches; the scan pool and its router as each index holds them.
It saves them under ``build/kernel_ab/``.  Then every tree times
``fused_lookup`` (fresh flow on and off, verify chunk, tiered),
``streamed_lookup`` (the same fresh and tiered batches), ``nf_forward``
(2^24 keys, the write batches) and ``fused_range_scan`` through its own
wrappers (``--kernels`` picks some), each in a process of its own, in
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
searches, the router in device memory, and the NF one key a thread.

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
}
KERNELS = tuple(CASES)
WORK = ROOT / "build" / "kernel_ab"
N_VERIFY_CHUNKS = 16
VERIFY_CHUNK = 4096

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

    def stream_pack(n):
        sp = n.index._serving.stream_pack()
        return ([t.clone() for t in sp.pool], sp.router.clone(), sp.window)

    save = {"kw": cs.lookup_kw(nfl), "packed_w": nfl._packed_w,
            "pools": list(nfl.index._kernel_pools()),
            "stream": stream_pack(nfl), "skw": cs.stream_kw(nfl)}
    save["fresh"] = lookups(ll["batches"])
    # nf_forward: the bulk load's transform, and the inserts of each
    # write_heavy batch (NFL._pkeys)
    save["nf_full"] = torch.from_numpy(nfl._feats(ll["wl"].load_keys))
    wl = m.make_workload(ll["keys"], m.WorkloadConfig(
        mix="write_heavy", n_ops=cs.N_WRITE_BATCHES * cs.BATCH,
        batch_size=cs.BATCH, zipf_s=0.99, seed=ll["seed"]))
    save["nf_batch"] = [torch.from_numpy(nfl._feats(k[op != 0]))
                        for op, k, _p in wl.batches]
    save["nf_shape"] = (nfl._shapes, nfl.cfg.flow.dim)
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
    save["stats"] = {"run_len": st["run_len"], "delta_len": st["delta_len"],
                     "serving": st["serving"]}
    ln = cs.bulkload_and_read("lognormal", cs.LOGNORMAL_KEYS, False, 1, m,
                              win)
    save["kw_off"] = cs.lookup_kw(ln["nfl"])
    save["pools_off"] = list(ln["nfl"].index._kernel_pools())
    save["stream_off"] = stream_pack(ln["nfl"])
    save["skw_off"] = cs.stream_kw(ln["nfl"])
    save["fresh_off"] = [cs.lookup_args(ln["nfl"], k, dev, split_key_bits)[:3]
                         for k in ln["batches"]]
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(save, out)
    print("AB-PREPARED " + json.dumps(save["stats"], default=str), flush=True)


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
    pools = KernelPools(*d["pools"])
    pw = d["packed_w"].cpu()

    def tiers_of(t):
        return TierPack(TierPools(*t[0]), *t[1:])

    def stream_of(s):
        return StreamPack(ScanPool(*s[0]), s[1], s[2])

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
    """The kernels whose sources variant ``name`` of ``label`` patches."""
    files = {f for f, _old, _new in VARIANTS[label][name]}
    return tuple(k for k, (lib, _cases) in CASES.items()
                 if f"{lib}.cu" in files or any(f.endswith(".cuh")
                                                for f in files))


def run(args) -> int:
    inputs = WORK / "inputs.pt"
    trees = [t.split("=", 1) for t in args.tree]
    kernels = tuple(args.kernels or KERNELS)
    r = subprocess.run([sys.executable, __file__, "prepare", str(inputs),
                        trees[0][1]], capture_output=True, text=True)
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
    p = sub.add_parser("prepare")
    p.add_argument("out")
    p.add_argument("tree")
    p = sub.add_parser("time")
    p.add_argument("tree")
    p.add_argument("label")
    p.add_argument("inputs")
    p.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS)
    p.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if args.cmd == "prepare":
        prepare(Path(args.out), args.tree)
        return 0
    if args.cmd == "time":
        out = time_side(args.tree, args.label, Path(args.inputs), args.check,
                        tuple(args.kernels))
        print("AB " + json.dumps(out), flush=True)
        return 0
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
