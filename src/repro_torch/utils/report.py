"""Markdown tables from the dry run's artifacts.

Port of ``repro.utils.report``: the dry-run table (what a card holds and
moves, and on a mesh the collective bytes it sends) and the roofline
table (``roofline.analyze_artifact``), both counted on the meta device
without a card.  The mesh column is "1" for the one-card search's rows.

  PYTHONPATH=src python -m repro_torch.utils.report [dryrun|roofline]
      [--dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

from repro_torch.launch.dryrun import ARTIFACT_DIR
from repro_torch.utils.roofline import analyze_artifact

__all__ = ["dryrun_table", "roofline_table", "main"]

_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def _artifacts(art_dir: Optional[str] = None) -> List[dict]:
    art_dir = art_dir or ARTIFACT_DIR
    arts = []
    for fn in sorted(os.listdir(art_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(art_dir, fn)) as f:
                arts.append(json.load(f))
    arts.sort(key=lambda a: (a["arch"], _ORDER.get(a["shape"], 9),
                             _mesh(a)))
    return arts


def _mesh(a) -> str:
    return "x".join(str(n) for n in a["mesh"].values()) if a.get("mesh") \
        else "1"


def dryrun_table(art_dir: Optional[str] = None) -> str:
    rows = ["| arch | shape | batch/card | cards | GFLOP/card bf16 "
            "| GFLOP/card f32 | GB accessed | args GB | peak GB "
            "| fits 80G | collective GB | mesh |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for a in _artifacts(art_dir):
        c = a["counts"]
        f32 = c.get("flops_f32", 0.0) + c.get("flops_tf32", 0.0)
        fits = "yes" if a["fits"] else "**NO**"
        coll = a.get("collective_bytes", {}).get("total", 0.0)
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['batch']} "
            f"| {a['cards']:g} | {c.get('flops_bf16', 0.0) / 1e9:.1f} "
            f"| {f32 / 1e9:.1f} | {c['bytes'] / 1e9:.1f} "
            f"| {c['argument_bytes'] / 1e9:.2f} "
            f"| {c['peak_bytes'] / 1e9:.2f} | {fits} | {coll / 1e9:.2f} "
            f"| {_mesh(a)} |")
    return "\n".join(rows)


def roofline_table(art_dir: Optional[str] = None) -> str:
    rows = ["| arch | shape | compute ms | memory ms | collective ms "
            "| bound | MODEL_TF | useful frac | roofline frac | mesh |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for a in _artifacts(art_dir):
        r = analyze_artifact(a)
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['compute_s'] * 1e3:.2f} | {r['memory_s'] * 1e3:.2f} "
            f"| {r['collective_s'] * 1e3:.2f} | **{r['bound']}** "
            f"| {r['model_flops'] / 1e12:.1f} "
            f"| {r['useful_frac']:.1%} | {r['roofline_frac']:.1%} "
            f"| {r['mesh']} |")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", nargs="?", default="all",
                    choices=("all", "dryrun", "roofline"))
    ap.add_argument("--dir", default=None,
                    help=f"artifact directory (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)
    if args.what in ("dryrun", "all"):
        print("### Dry-run table (per H100 80GB, counted on meta)\n")
        print(dryrun_table(args.dir))
    if args.what in ("roofline", "all"):
        print("\n### Roofline (per card at its batch, counted on meta)\n")
        print(roofline_table(args.dir))


if __name__ == "__main__":
    main()
