"""One model-node probe: slot prediction, entry gather, DATA identity hit.

Port of ``repro.kernels.index_probe`` (and its oracle
``repro.kernels.ref.index_probe_ref``).  ``index_probe`` launches the
CUDA kernel (``csrc/index_probe.cu``: one query a thread, the code and
child at the slot, then a DATA entry's identity halves and payload in
one round) on CUDA tensors and runs ``index_probe_plain`` on CPU
tensors.  Per query:
``slot = clamp(rint(slope * q + intercept), 0, S - 1)`` with the multiply
and the add rounded separately (as the numpy builder places keys), the
entry code and child id at the slot, and the payload where the entry is
DATA and its identity halves equal the query's, else -1.  Identity
halves are int32 bit views of the u32 pools; only equality is taken.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.fused_lookup import DATA, _slot_index

__all__ = ["index_probe", "index_probe_plain"]


class _ProbeArgs(ctypes.Structure):
    """Mirror of ``ProbeArgs`` in csrc/index_probe.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "qkey", "qhi", "qlo", "etype", "ehi", "elo", "epay", "echild",
        "out_pay", "out_code", "out_child")]
        + [("slope", ctypes.c_float), ("intercept", ctypes.c_float),
           ("B", ctypes.c_int), ("S", ctypes.c_int)])


def _f32(x) -> np.float32:
    """A node parameter (Python number, numpy or 0-d tensor) as f32."""
    return np.float32(x.item() if isinstance(x, torch.Tensor) else x)


def index_probe_plain(qkey: torch.Tensor, qhi: torch.Tensor,
                      qlo: torch.Tensor, slope, intercept,
                      etype: torch.Tensor, ehi: torch.Tensor,
                      elo: torch.Tensor, epayload: torch.Tensor,
                      echild: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the probe, on ``qkey``'s device.  Returns
    (payload i32[B] or -1, entry code i32[B], child id i32[B])."""
    dev = qkey.device
    s = int(etype.shape[0])
    sl = torch.tensor(_f32(slope), dtype=torch.float32, device=dev)
    ic = torch.tensor(_f32(intercept), dtype=torch.float32, device=dev)
    slot = _slot_index(sl * qkey.to(torch.float32) + ic)
    slot = torch.clamp(slot, 0, s - 1)
    et = etype[slot].to(torch.int32)
    hit = (et == DATA) & (ehi[slot] == qhi) & (elo[slot] == qlo)
    pay = torch.where(hit, epayload[slot].to(torch.int32),
                      torch.full_like(et, -1))
    return pay, et, echild[slot].to(torch.int32)


def index_probe(qkey: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
                slope, intercept, etype: torch.Tensor, ehi: torch.Tensor,
                elo: torch.Tensor, epayload: torch.Tensor,
                echild: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe one model node with a query batch -> (payload, entry code,
    child id), each i32[B].

    qkey: f32[B] positioning keys; qhi/qlo: i32[B] identity bit views;
    slope/intercept: the node's model (numbers, taken as f32); etype,
    ehi, elo, epayload, echild: the node's i32[S] entry arrays, on the
    device of qkey.  CUDA tensors launch ``csrc/index_probe.cu`` (and
    count the launch); CPU tensors run ``index_probe_plain``."""
    if qkey.device.type == "cpu":
        return index_probe_plain(qkey, qhi, qlo, slope, intercept, etype,
                                 ehi, elo, epayload, echild)
    if qkey.device.type != "cuda":
        raise ValueError(f"unsupported device {qkey.device}")
    b = int(qkey.shape[0])
    s = int(etype.shape[0])
    entries = (etype, ehi, elo, epayload, echild)
    for t in (qkey, qhi, qlo, *entries):
        if t.device != qkey.device or not t.is_contiguous():
            raise ValueError("index_probe inputs must be contiguous and on "
                             "one device")
    if qkey.dtype != torch.float32 or qkey.dim() != 1:
        raise ValueError("qkey must be f32[B]")
    if qhi.dtype != torch.int32 or qlo.dtype != torch.int32 \
            or qhi.shape != (b,) or qlo.shape != (b,):
        raise ValueError("qhi/qlo must be i32[B] identity bit views")
    if s == 0 or any(t.dtype != torch.int32 or t.shape != (s,)
                     for t in entries):
        raise ValueError("entry arrays must be i32[S], S > 0")
    pay = torch.empty(b, dtype=torch.int32, device=qkey.device)
    code = torch.empty(b, dtype=torch.int32, device=qkey.device)
    child = torch.empty(b, dtype=torch.int32, device=qkey.device)
    if b == 0:
        return pay, code, child
    a = _ProbeArgs()
    a.qkey, a.qhi, a.qlo = qkey.data_ptr(), qhi.data_ptr(), qlo.data_ptr()
    a.etype, a.ehi, a.elo, a.epay, a.echild = (t.data_ptr() for t in entries)
    a.out_pay, a.out_code, a.out_child = (pay.data_ptr(), code.data_ptr(),
                                          child.data_ptr())
    a.slope, a.intercept = float(_f32(slope)), float(_f32(intercept))
    a.B, a.S = b, s
    fn = build.function("index_probe", "index_probe_launch",
                        [ctypes.POINTER(_ProbeArgs), ctypes.c_void_p])
    build.check(fn(ctypes.byref(a), build.stream_ptr(qkey.device)),
                "index_probe")
    counters.launched(index_probe)
    return pay, code, child


index_probe.launches = 0
