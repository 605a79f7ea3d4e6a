"""Kernel-contract checker of the port (DESIGN.md §15).

Port of ``repro.analysis``: its purpose, not its jaxpr/HLO mechanism.
Four machine-checked contracts over the port's *registered* serving
entries and CUDA sources, each the executable form of a bug class:

- ``host-sync``    — no entry blocks the host on the card beyond its
                     declared budget (a recorder of the syncing calls,
                     and on the card ``torch.cuda.set_sync_debug_mode``)
- ``alloc-budget`` — device buffers, routers and kernel libraries are
                     allocated, built and loaded once per declared
                     capacity bucket, pool version and source
- ``smem``         — each kernel's shared memory per block, modelled
                     from the sources, proved against the H100's limit
                     and calibrated against ptxas and the profiler
- ``lint``         — clamped gathers, unsigned lane casts, f64 and
                     spills in the PTX; batch-length loops in the
                     profiler's launch facts

Run ``python -m repro_torch.analysis`` (``--device cpu`` without a card).
"""

from repro_torch.analysis.findings import Finding, Report, load_allowlist

__all__ = ["Finding", "Report", "load_allowlist"]
