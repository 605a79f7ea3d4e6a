"""The one lock over every counter of the port's kernels and dispatch shims.

Each kernel wrapper counts a launch with ``launched`` (its function's
``launches``, and ``launch_sizes`` where it keeps them); ``kernels.ops``
bumps its dispatch and fault counters and takes its snapshots under the
same ``LOCK``, so a snapshot-and-reset is one critical section and a
launch from another thread lands in this window or the next, never in
none.  A re-entrant lock: ``NFL.dispatch_stats`` holds it around the
several snapshots it takes.
"""

from __future__ import annotations

import threading

__all__ = ["LOCK", "launched"]

LOCK = threading.RLock()


def launched(fn, size=None) -> None:
    """Count one launch of the kernel wrapper ``fn`` (and one of batch
    ``size`` when the wrapper keeps its launches by size)."""
    with LOCK:
        fn.launches += 1
        if size is not None:
            fn.launch_sizes[size] += 1
