"""Phase 6d of a checkout's ``chip_smoke.py``, alone, in a fresh process.

    python3 src/repro_torch/smoke_phase.py ROOT

``ROOT`` is the root of a checkout of the port (its ``chip_smoke.py``
and ``src``).  Builds that checkout's kernels, then serves qwen3-14b at
its full config as phase 6d does (``chip_smoke.dense_phase``: prefill
tokens/s, TTFT, decode step ms, every check of the phase).  In a fresh
process a one-time cost (an import, a first call) falls on the first
requests, as it does on a newly launched server, where the full smoke
has paid it in an earlier phase.  To compare checkouts, run it once per
checkout in turns (A, B, B, A) on one card.  Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys


def main(argv) -> None:
    root = os.path.abspath(argv[1])
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    card = cs.card_line()
    cs.log("tree", root, card)
    cs.phase_build(build)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.dense_phase(cs.Windows(ops), 0, card)


if __name__ == "__main__":
    main(sys.argv)
