"""The one lock over every counter of the port's kernels and dispatch shims.

Each kernel wrapper counts a launch with ``launched`` (its function's
``launches``, and ``launch_sizes`` where it keeps them); ``kernels.ops``
bumps its dispatch and fault counters and takes its snapshots under the
same ``LOCK``, so a snapshot-and-reset is one critical section and a
launch from another thread lands in this window or the next, never in
none.  A re-entrant lock: ``NFL.dispatch_stats`` holds it around the
several snapshots it takes.

On meta tensors a wrapper launches nothing and counts no launch: it
hands its kernel's work (bytes, FLOPs, exponentials, from its work
function) to ``count_work``, which gives it to every active dispatch
mode that takes kernel work (``utils.roofline.WorkCounter``).
"""

from __future__ import annotations

import threading

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["LOCK", "launched", "count_work"]

LOCK = threading.RLock()


def launched(fn, size=None) -> None:
    """Count one launch of the kernel wrapper ``fn`` (and one of batch
    ``size`` when the wrapper keeps its launches by size)."""
    with LOCK:
        fn.launches += 1
        if size is not None:
            fn.launch_sizes[size] += 1


def count_work(name: str, work: dict) -> None:
    """Hand one meta call's kernel work to the active work counters."""
    for mode in _get_current_dispatch_mode_stack():
        add = getattr(mode, "add_kernel_work", None)
        if add is not None:
            add(name, work)
