"""Mamba1 selective scan: the fused kernel and its plain version.

Port of ``repro.kernels.mamba_scan`` (and of its oracle
``repro.kernels.ref.mamba_scan_ref``).  ``mamba_scan`` launches the CUDA
kernel (``csrc/mamba_scan.cu``: a group of lanes per channel, the state
in registers for the whole sequence, dt, x, B and C staged through
shared memory a time chunk at a time, as ``scan_plan`` sizes them) on
CUDA tensors and runs ``mamba_scan_plain`` on CPU tensors.  Per batch
row and channel d:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  A = -exp(a_log)
    y_t = sum_n h_t[n] * C_t[n]

from ``h_0 = 0``; returns y and drops the final state, as the JAX
wrapper does.  The JAX function's ``chunk`` and ``dblock`` size TPU
blocks (VMEM tiling); the plan's ``chunk`` sizes the shared-memory stages
instead, and the card needs no padding of L and takes any di.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["mamba_scan", "mamba_scan_plain", "scan_plan", "ScanPlan",
           "MAX_STATE"]

MAX_STATE = 128      # LANES x the widest NPL the kernel is built for
CHANNEL_TILE = 32    # csrc/mamba_scan.cu CT: channels per block
LANES = 8            # lanes per channel once N reaches it
SMEM_BUDGET = 100 * 1024   # bytes: two blocks of a plan fit on an SM
# (lanes, states per lane) pairs that csrc/mamba_scan.cu instantiates
KERNELS = frozenset({(1, 1), (2, 1), (4, 1), (8, 1), (8, 2), (8, 4),
                     (8, 8), (8, 16)})


class ScanPlan(NamedTuple):
    """How the kernel cuts a scan: ``lanes`` per channel, each keeping
    ``npl`` states; ``channel_tile`` channels per block; time staged in
    chunks of ``chunk`` steps, double-buffered, with each lane's share of
    y, in ``smem_bytes`` of shared memory; ``blocks`` blocks of
    ``channel_tile * lanes`` threads."""

    lanes: int
    npl: int
    chunk: int
    channel_tile: int
    blocks: int
    smem_bytes: int


class _MambaArgs(ctypes.Structure):
    """Mirror of ``MambaArgs`` in csrc/mamba_scan.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "dt", "xi", "b_in", "c_out", "a_neg", "y")]
        + [(n, ctypes.c_int) for n in ("B", "L", "di", "N", "lanes", "npl",
                                       "chunk")])


def scan_plan(b: int, l: int, di: int, n: int) -> ScanPlan:
    """The kernel's cut of a [B, L, di] x N scan, 0 < N <= ``MAX_STATE``:
    ``min(LANES, next_pow2(N))`` lanes per channel, each with the next
    power of two of ``N / lanes`` states (a pair in ``KERNELS``); the
    longest chunk of 64, 32 or 16 steps whose two stages and lane sums
    fit ``SMEM_BUDGET``."""
    g = min(LANES, 1 << (n - 1).bit_length())
    npl = 1 << (-(-n // g) - 1).bit_length()
    ct = CHANNEL_TILE

    def smem(chunk):
        return 4 * (2 * (2 * chunk * ct + 2 * chunk * n) + chunk * ct * g)

    chunk = next((c for c in (64, 32) if smem(c) <= SMEM_BUDGET), 16)
    return ScanPlan(g, npl, chunk, ct, -(-di // ct) * b, smem(chunk))


def mamba_scan_plain(dt: torch.Tensor, xi: torch.Tensor, b_in: torch.Tensor,
                     c_out: torch.Tensor, a_log: torch.Tensor
                     ) -> torch.Tensor:
    """The exact recurrence as a loop over t, as ``mamba_scan_ref``
    computes it, on the inputs' device: the whole [B, di, N] state, one
    step at a time.  dt, xi f32[B, L, di]; b_in, c_out f32[B, L, N];
    a_log f32[di, N] -> y f32[B, L, di]."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))                       # [di, N]
    dt, xi = dt.to(f32), xi.to(f32)
    b_in, c_out = b_in.to(f32), c_out.to(f32)
    b, l, di = dt.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=f32, device=dt.device)
    y = torch.empty((b, l, di), dtype=f32, device=dt.device)
    for t in range(l):
        a_bar = torch.exp(dt[:, t, :, None] * a)        # [B, di, N]
        bx = (dt[:, t] * xi[:, t])[:, :, None] * b_in[:, t, None, :]
        h = a_bar * h + bx
        y[:, t] = torch.sum(h * c_out[:, t, None, :], dim=-1)
    return y


def mamba_scan(dt: torch.Tensor, xi: torch.Tensor, b_in: torch.Tensor,
               c_out: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """Selective scan -> y f32[B, L, di].

    dt, xi: f32[B, L, di] (softplus'd step sizes, conv+silu'd inputs);
    b_in, c_out: f32[B, L, N]; a_log: f32[di, N]; all contiguous on one
    device, N <= 128.  CUDA tensors launch ``csrc/mamba_scan.cu`` as
    ``scan_plan`` cuts it (and count the launch); CPU tensors run
    ``mamba_scan_plain``."""
    if dt.device.type == "cpu":
        return mamba_scan_plain(dt, xi, b_in, c_out, a_log)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    for t in (dt, xi, b_in, c_out, a_log):
        if t.device != dt.device or not t.is_contiguous():
            raise ValueError("mamba_scan inputs must be contiguous and on "
                             "one device")
        if t.dtype != torch.float32:
            raise ValueError(f"mamba_scan takes f32 inputs, got {t.dtype}")
    if dt.dim() != 3 or xi.shape != dt.shape:
        raise ValueError("dt and xi must be f32[B, L, di] of one shape")
    b, l, di = dt.shape
    if b_in.dim() != 3 or b_in.shape[:2] != (b, l) \
            or c_out.shape != b_in.shape:
        raise ValueError("b_in and c_out must be f32[B, L, N]")
    n = int(b_in.shape[2])
    if a_log.shape != (di, n):
        raise ValueError("a_log must be f32[di, N]")
    if not 0 < n <= MAX_STATE or b > 65535:
        raise ValueError(f"mamba_scan takes 0 < N <= {MAX_STATE} and "
                         "B <= 65535")
    plan = scan_plan(b, l, di, n)
    y = torch.empty((b, l, di), dtype=torch.float32, device=dt.device)
    if y.numel() == 0:
        return y
    a_neg = -torch.exp(a_log)
    a = _MambaArgs()
    a.dt, a.xi, a.b_in, a.c_out = (t.data_ptr() for t in (dt, xi, b_in,
                                                          c_out))
    a.a_neg, a.y = a_neg.data_ptr(), y.data_ptr()
    a.B, a.L, a.di, a.N = b, l, di, n
    a.lanes, a.npl, a.chunk = plan.lanes, plan.npl, plan.chunk
    fn = build.load("mamba_scan").mamba_scan_launch
    fn.argtypes = [ctypes.POINTER(_MambaArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(ctypes.byref(a), build.stream_ptr(dt.device)),
                "mamba_scan")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0
