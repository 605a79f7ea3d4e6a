"""Deliberately broken kernels and serving code for the checker's
self-test (DESIGN.md §15).

Port of ``repro.analysis.fixtures``.  Each fixture re-introduces one bug
class that a contract exists to catch, so that the self-test can assert
the checker reports it with a file and line, and a refactor of the
checks cannot silently stop detecting the bug that motivated them.
Where the JAX fixtures are traced, never run, the port's are real:

* four hand-written CUDA kernels in ``csrc/fixtures.cu``, each with a
  wrapper (the kernel on a CUDA tensor, its plain PyTorch version on a
  CPU tensor) and a launch counter: ``clip_gather`` (B8, a clamped
  gather: ``lint:clamp-gather``), ``lane_cast`` (B9, u32 identity lanes
  through f32: ``lint:lane-cast``), ``batch_loop`` (B10, one thread over
  the whole batch: ``lint:batch-loop``) and ``f64_upcast`` (a table
  computed in double: ``lint:f64``);
* ``host_fetch_serve``, a serving wrapper that fetches to the host on
  every dispatch (``host-sync``);
* ``RungReallocDeviceTier``, a ``DeviceTier`` that reallocates at the
  pow2 rung of each refresh instead of keeping its capacity bucket
  (``alloc-budget``).

``FIXTURES`` holds one record per fixture: the check that must catch
it, its kernel and wrapper where it has one, and the JAX fixture it
ports.  The checks import lazily, so the CPU tests import this module
freely.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.serving_state import DeviceTier, pow2_bucket
from repro_torch.kernels import build

__all__ = ["clip_gather", "clip_gather_plain", "lane_cast", "lane_cast_plain",
           "batch_loop", "batch_loop_plain", "f64_upcast", "f64_upcast_plain",
           "host_fetch_serve", "RungReallocDeviceTier", "Fixture", "FIXTURES",
           "KERNELS", "fixture_inputs", "f64_table", "launch_counts",
           "reset_launch_counts"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _cuda_args(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous and on one "
                             "device")


def _launch(symbol: str, argtypes, *args) -> None:
    fn = build.function("fixtures", symbol, argtypes)
    build.check(fn(*args), symbol)


# ------------------------------------------------------- B8 clip gather
def clip_gather_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, len(table) - 1)]``: the JAX fixture's
    ``jnp.take(table, idx, mode="clip")``."""
    return table[torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)]


def clip_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """idx i32[n], table f32[m] -> f32[n]: the ``clip_gather_kernel`` on
    CUDA tensors, ``clip_gather_plain`` on CPU tensors."""
    if idx.dtype != torch.int32 or table.dtype != torch.float32 \
            or idx.dim() != 1 or table.dim() != 1 or table.shape[0] == 0:
        raise ValueError("clip_gather takes idx i32[n] and table f32[m > 0]")
    if idx.device.type == "cpu":
        return clip_gather_plain(idx, table)
    _cuda_args("clip_gather", idx, table)
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=idx.device)
    if out.numel() == 0:
        return out
    _launch("clip_gather_launch", [_P, _P, _P, _I, _I, _P], idx.data_ptr(),
            table.data_ptr(), out.data_ptr(), int(idx.shape[0]),
            int(table.shape[0]), build.stream_ptr(idx.device))
    clip_gather.launches += 1
    return out


# -------------------------------------------------------- B9 lane cast
def lane_cast_plain(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``f32(hi) * 2^32 + f32(lo)`` of two u32 lanes held as int32 bit
    views, widened through int64 (each value below 2^32 rounds to f32
    once, as ``__uint2float_rn`` rounds it)."""
    def u32(x):
        return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    return u32(hi) * 4294967296.0 + u32(lo)


def lane_cast(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hi, lo i32[n] (u32 identity lanes as bit views) -> f32[n]: the
    ``lane_cast_kernel`` on CUDA tensors, ``lane_cast_plain`` on CPU
    tensors."""
    if hi.dtype != torch.int32 or lo.dtype != torch.int32 \
            or hi.dim() != 1 or lo.shape != hi.shape:
        raise ValueError("lane_cast takes two i32[n] lane bit views")
    if hi.device.type == "cpu":
        return lane_cast_plain(hi, lo)
    _cuda_args("lane_cast", hi, lo)
    out = torch.empty(hi.shape[0], dtype=torch.float32, device=hi.device)
    if out.numel() == 0:
        return out
    _launch("lane_cast_launch", [_P, _P, _P, _I, _P], hi.data_ptr(),
            lo.data_ptr(), out.data_ptr(), int(hi.shape[0]),
            build.stream_ptr(hi.device))
    lane_cast.launches += 1
    return out


# ------------------------------------------------------ B10 batch loop
def batch_loop_plain(q: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Per query, the count of pool keys ``<= q`` (i32)."""
    return (pool[None, :] <= q[:, None]).sum(dim=1).to(torch.int32)


def batch_loop(q: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """q f32[B], pool f32[P] -> i32[B]: the ``batch_loop_kernel`` (one
    block of one thread looping over the batch) on CUDA tensors,
    ``batch_loop_plain`` on CPU tensors."""
    if q.dtype != torch.float32 or pool.dtype != torch.float32 \
            or q.dim() != 1 or pool.dim() != 1:
        raise ValueError("batch_loop takes q f32[B] and pool f32[P]")
    if q.device.type == "cpu":
        return batch_loop_plain(q, pool)
    _cuda_args("batch_loop", q, pool)
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    if out.numel() == 0:
        return out
    _launch("batch_loop_launch", [_P, _P, _P, _I, _I, _P], q.data_ptr(),
            pool.data_ptr(), out.data_ptr(), int(q.shape[0]),
            int(pool.shape[0]), build.stream_ptr(q.device))
    batch_loop.launches += 1
    return out


# ------------------------------------------------------- f64 upcast
def f64_table(table_len: int) -> torch.Tensor:
    """The fixture's table: ``f32(j / (table_len - 1))`` computed in
    double, as the kernel computes it."""
    j = torch.arange(table_len, dtype=torch.float64)
    return (j / float(table_len - 1)).to(torch.float32)


def f64_upcast_plain(pk: torch.Tensor, table_len: int = 8) -> torch.Tensor:
    """``searchsorted`` (left) of ``pk`` into the f32 image of
    ``linspace(0, 1, table_len)``: the count of table entries below each
    key (i32)."""
    table = f64_table(table_len).to(pk.device)
    return (table[None, :] < pk[:, None]).sum(dim=1).to(torch.int32)


def f64_upcast(pk: torch.Tensor, table_len: int = 8) -> torch.Tensor:
    """pk f32[n] -> i32[n]: the ``f64_upcast_kernel`` on CUDA tensors,
    ``f64_upcast_plain`` on CPU tensors; ``table_len >= 2``."""
    if pk.dtype != torch.float32 or pk.dim() != 1 or table_len < 2:
        raise ValueError("f64_upcast takes pk f32[n] and table_len >= 2")
    if pk.device.type == "cpu":
        return f64_upcast_plain(pk, table_len)
    _cuda_args("f64_upcast", pk)
    out = torch.empty(pk.shape[0], dtype=torch.int32, device=pk.device)
    if out.numel() == 0:
        return out
    _launch("f64_upcast_launch", [_P, _P, _I, _I, _P], pk.data_ptr(),
            out.data_ptr(), int(pk.shape[0]), int(table_len),
            build.stream_ptr(pk.device))
    f64_upcast.launches += 1
    return out


# ----------------------------------------------------- host fetch
def _host_probe(z: np.ndarray) -> np.ndarray:
    return np.zeros(z.shape, np.int32)


def host_fetch_serve(pk: torch.Tensor) -> torch.Tensor:
    """A "serving" wrapper that goes to the host on every dispatch —
    the oracle-fallback bug class (the JAX fixture's ``pure_callback``):
    ``(pk * 2 -> host probe) + 1``."""
    z = pk * 2.0
    hit = torch.from_numpy(_host_probe(z.cpu().numpy())).to(pk.device)
    return hit + 1


# ----------------------------------------------------- rung realloc
class RungReallocDeviceTier(DeviceTier):
    """Drop-in broken ``DeviceTier``: every refresh whose pow2 rung
    differs from the buffer's capacity reallocates at the rung (the
    rung-crossing class: sized to the live prefix, not to the capacity bucket
    that ``preallocate`` and growth declare), so a tier whose length
    drifts across rungs allocates again and again.  Swapped into a
    ``ServingState`` through ``alloc.drive_lattice(tier_factory=...)``."""

    def refresh(self, pk, hi, lo, pv, window) -> None:
        rung = pow2_bucket(int(pk.shape[0]) + 1)
        if self.pk is not None and rung != self.capacity:
            # THE BUG: the rung's buffers replace the bucket's; the
            # prefix write below fills them whole
            self.length = 0
            self._alloc(rung)
        DeviceTier.refresh(self, pk, hi, lo, pv, window)


# --------------------------------------------------------- the map
def fixture_inputs(name: str, device, seed: int = 0):
    """The fixture kernel's arguments at the JAX fixture's shapes (B8 and
    B9: 128 lanes, B10: 4,096 queries over 256 keys, f64: 64 keys), made
    from ``seed``: clamped indices past both ends, lanes 0 and 2^32 - 1,
    ties, keys at the table's entries."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    if name == "fixture:clip-gather":
        idx = rng.integers(-40, 171, 128).astype(np.int32)
        idx[:4] = [-40, -1, 127, 170]
        args = (idx, rng.standard_normal(128).astype(np.float32))
    elif name == "fixture:lane-cast":
        lanes = rng.integers(0, 1 << 32, (2, 128), dtype=np.uint64)
        lanes[:, :2] = [[0, 0xFFFFFFFF], [0xFFFFFFFF, 0]]
        args = tuple(x.astype(np.uint32).view(np.int32) for x in lanes)
    elif name == "fixture:batch-loop":
        pool = rng.standard_normal(256).astype(np.float32)
        q = rng.standard_normal(4096).astype(np.float32)
        q[:2] = pool[:2]
        args = (q, pool)
    else:
        pk = rng.uniform(-0.2, 1.2, 64).astype(np.float32)
        pk[:8] = f64_table(8).numpy()
        args = (pk,)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in args)


@dataclasses.dataclass(frozen=True)
class Fixture:
    """One broken fixture: the contract ``check`` that must catch it and
    the JAX fixture it ports (``replaces``, the ``def`` in
    ``src/repro/analysis/fixtures.py``); a kernel fixture also names its
    wrapper (``call``) and its ``__global__`` in ``csrc/fixtures.cu``
    (``kernel``), and needs the card."""

    name: str
    check: str
    replaces: str
    call: Optional[Callable] = None
    kernel: Optional[str] = None

    @property
    def needs_card(self) -> bool:
        return self.kernel is not None

    def run(self, report, device, ptx_text: Optional[str] = None) -> None:
        """Run the fixture on ``device`` through the check that must
        catch it, adding that check's findings to ``report`` (a kernel
        fixture's PTX is compiled now unless ``ptx_text`` is given)."""
        from repro_torch.analysis import alloc, contracts, ptx_checks

        if self.check == "host-sync":
            contracts.check_host_fetch_fixture(report, device)
        elif self.check == "alloc-budget":
            alloc.check_rung_realloc_fixture(report, device)
        elif self.check == "lint:batch-loop":
            contracts.check_batch_loop_fixture(report, device)
        else:
            # one launch at the fixture's shape, then its PTX
            self.call(*fixture_inputs(self.name, device))
            ptx_checks.check_fixture_kernel(report, self.name, self.kernel,
                                            ptx_text)


_JAX = "src/repro/analysis/fixtures.py"
FIXTURES = {f.name: f for f in (
    Fixture("fixture:clip-gather", "lint:clamp-gather", f"{_JAX}:38",
            clip_gather, "clip_gather_kernel"),
    Fixture("fixture:host-fetch", "host-sync", f"{_JAX}:51"),
    Fixture("fixture:lane-cast", "lint:lane-cast", f"{_JAX}:72",
            lane_cast, "lane_cast_kernel"),
    Fixture("fixture:batch-loop", "lint:batch-loop", f"{_JAX}:95",
            batch_loop, "batch_loop_kernel"),
    Fixture("fixture:f64-upcast", "lint:f64", f"{_JAX}:104",
            f64_upcast, "f64_upcast_kernel"),
    Fixture("fixture:rung-realloc", "alloc-budget", f"{_JAX}:155"),
)}
# the kernel wrappers, each with its launch counter
KERNELS = tuple(f.call for f in FIXTURES.values() if f.call is not None)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict:
    """Fixture kernel launches since the last reset (CUDA only)."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
