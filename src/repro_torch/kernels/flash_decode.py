"""One-token GQA decode attention: the kernel and its plain version.

Port of ``repro.kernels.flash_decode`` behind ``ops.flash_decode``, its
one entry point (no model of either package calls it: the models' decode
attention is an einsum softmax).  ``flash_decode`` launches the CUDA
kernel (``csrc/flash_decode.cu``: one block per (batch row, q head), an
online softmax per warp over the positions below ``kv_len``) on CUDA
tensors and runs ``flash_decode_plain`` on CPU tensors.

Semantics are the Pallas wrapper's: q [B, H, D] pre-scaled, k/v
[B, S, KH, D], kv head = q head // (H / KH), positions at or past
``kv_len[b]`` masked, output ``o / max(l, 1e-20)`` as f32 [B, H, D], so a
row with ``kv_len == 0`` gives 0 (``flash_decode_ref``, a full softmax,
gives NaN there).  ``kv_len > S`` is not defined by the JAX wrapper; here
both versions read positions below ``min(kv_len, S)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["flash_decode", "flash_decode_plain", "BLOCK", "NEG_INF",
           "MAX_HEAD_DIM"]

BLOCK = 256          # the Pallas kernel's KV block (ops.flash_decode)
NEG_INF = -1e30
MAX_HEAD_DIM = 256   # csrc/flash_decode.cu MAX_D

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class _DecodeArgs(ctypes.Structure):
    """Mirror of ``DecodeArgs`` in csrc/flash_decode.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "kv_len",
                                                "o")]
                + [(n, ctypes.c_int) for n in ("B", "H", "KH", "S", "D",
                                               "dtype")])


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """The Pallas body's online softmax, block by block of ``BLOCK``
    positions, vectorised over (b, h), on the inputs' device: the
    ``NEG_INF`` mask, the alpha guard of an all-masked block and the
    final ``max(l, 1e-20)``.  Returns f32 [B, H, D]."""
    f32 = torch.float32
    q = q.to(f32)
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError("GQA needs q heads to be a multiple of kv heads")
    group = h // kh
    dev = q.device
    kv_len = kv_len.to(torch.int64)
    o = torch.zeros((b, h, d), dtype=f32, device=dev)
    m = torch.full((b, h), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, h), dtype=f32, device=dev)
    for s0 in range(0, s, BLOCK):
        kb = k[:, s0:s0 + BLOCK].to(f32).repeat_interleave(group, dim=2)
        vb = v[:, s0:s0 + BLOCK].to(f32).repeat_interleave(group, dim=2)
        pos = s0 + torch.arange(kb.shape[1], device=dev)
        valid = (pos[None, :] < kv_len[:, None])[:, None, :]   # [B, 1, blk]
        scores = torch.sum(kb.permute(0, 2, 1, 3) * q[:, :, None, :], -1)
        scores = torch.where(valid, scores, NEG_INF)            # [B, H, blk]
        m_new = torch.maximum(m, scores.max(dim=-1).values)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(valid, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.sum(
            p[..., None] * vb.permute(0, 2, 1, 3), dim=2)
        m = m_new
    return o / torch.clamp(l, min=1e-20)[..., None]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention -> f32 [B, H, D].

    q: [B, H, D] float (cast to f32 here, as the JAX wrapper does);
    k, v: [B, S, KH, D] of one dtype (f32, bf16 or f16), read in that
    dtype; kv_len: i32[B]; all contiguous on one device, D <= 256 and
    H a multiple of KH.  CUDA tensors launch ``csrc/flash_decode.cu``
    (and count the launch); CPU tensors run ``flash_decode_plain``."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for t in (q, k, v, kv_len):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_decode inputs must be contiguous and on "
                             "one device")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, H, D] and k, v [B, S, KH, D]")
    b, h, d = q.shape
    s, kh = int(k.shape[1]), int(k.shape[2])
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("k and v must be [B, S, KH, D] with q's B and D")
    if kh == 0 or h % kh:
        raise ValueError("GQA needs q heads to be a multiple of kv heads")
    if not q.dtype.is_floating_point or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError("q must be float and k, v one of f32, bf16, f16")
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,):
        raise ValueError("kv_len must be i32[B]")
    if not 0 < d <= MAX_HEAD_DIM or b > 65535:
        raise ValueError(f"flash_decode takes 0 < D <= {MAX_HEAD_DIM} and "
                         "B <= 65535")
    o = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o
    q32 = q.to(torch.float32).contiguous()
    a = _DecodeArgs()
    a.q, a.k, a.v = q32.data_ptr(), k.data_ptr(), v.data_ptr()
    a.kv_len, a.o = kv_len.data_ptr(), o.data_ptr()
    a.B, a.H, a.KH, a.S, a.D = b, h, kh, s, d
    a.dtype = _DTYPES[k.dtype]
    fn = build.load("flash_decode").flash_decode_launch
    fn.argtypes = [ctypes.POINTER(_DecodeArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(ctypes.byref(a), build.stream_ptr(q.device)),
                "flash_decode")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
