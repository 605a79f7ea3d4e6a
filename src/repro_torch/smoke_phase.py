"""One phase of a checkout's ``chip_smoke.py``, alone, in a fresh process.

    python3 src/repro_torch/smoke_phase.py ROOT [6d|r|m]

``ROOT`` is the root of a checkout of the port (its ``chip_smoke.py``
and ``src``).  Builds that checkout's kernels, then runs one phase with
every check it has in the full smoke:

* ``6d`` (the default) serves qwen3-14b at its full config as phase 6d
  does (``chip_smoke.dense_phase``: prefill tokens/s, TTFT, decode step
  ms).  In a fresh process a one-time cost (an import, a first call)
  falls on the first requests, as it does on a newly launched server,
  where the full smoke has paid it in an earlier phase.  To compare
  checkouts, run it once per checkout in turns (A, B, B, A) on one card.
* ``m`` serves qwen3-14b as 6d does, then runs phase m on its weights
  and served cache (``chip_smoke.mesh_phase``: m1 on the launched (1, 1)
  mesh, m2 one rank of (16, k) meshes under fake process groups, m3
  ``launch.train --mesh 1x1:data,model --elastic-demo``), and, with 6d's
  model freed, its moe, ssm and hybrid legs
  (``chip_smoke.mesh_families_phase``: m4 granite-moe-1b-a400m,
  falcon-mamba-7b and zamba2-2.7b on the (1, 1) mesh against the
  unsharded route, m5 one rank of arctic-480b on (16, 16) and of
  falcon-mamba-7b on (16, k) against the mesh dry run, m6 the mesh
  launcher on granite-moe-1b-a400m), then its vlm, encdec and
  ``batch_tp`` legs (``chip_smoke.mesh_families2_phase``: m7
  llama-3.2-vision-11b and whisper-medium on the (1, 1) mesh against the
  unsharded route, m8 one rank of each on (16, 16) ``decode_32k``, m9
  falcon-mamba-7b under ``batch_tp`` on (16, 2), m10 a ``Trainer`` with
  stub inputs on (1, 1) against none).
* ``r`` runs phase r: its dry runs beside the build, then r2 on phase
  6's model, r1 inside phase 6d and r3 after phase t's t1
  (``chip_smoke.roofline_*``), and prints phase r's summary.

Needs a CUDA device.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from pathlib import Path


def main(argv) -> None:
    root = os.path.abspath(argv[1])
    phase = argv[2] if len(argv) > 2 else "6d"
    if phase not in ("6d", "r", "m"):
        raise SystemExit(f"unknown phase {phase!r}: 6d, r or m")
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    card = cs.card_line()
    cs.log("tree", root, card)
    if phase in ("6d", "m"):
        cs.phase_build(build)
        torch.backends.cuda.matmul.allow_tf32 = False
        win = cs.Windows(ops)
        out = cs.dense_phase(win, 0, card, mesh=phase == "m")
        if phase == "m":
            m_out = out.pop("m")
            del out
            gc.collect()
            torch.cuda.empty_cache()
            cs.mesh_families_phase(win, card, m_out)
        return
    t0 = time.perf_counter()
    _, arts, out = cs.with_dryruns(Path(root), lambda: cs.phase_build(build))
    win = cs.Windows(ops)
    lm = cs.lm_serve(win, 0)
    out["r2"] = cs.roofline_prefill(win, lm, arts["r2"], arts["r2_b1"], card)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    out["r1"] = cs.dense_phase(win, 0, card, arts["r1"])["r1"]
    gc.collect()
    torch.cuda.empty_cache()
    out["r3"] = cs.train_full(win, card, arts["r3"])["r3"]
    cs.log("[r] summary " + json.dumps(out, default=str))
    cs.log(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv)
