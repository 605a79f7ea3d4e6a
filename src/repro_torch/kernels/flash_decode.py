"""One-token GQA decode attention: the kernel, its split plan and its plain
version.

Port of ``repro.kernels.flash_decode`` behind ``ops.flash_decode``, its
one entry point, which every LM family's decode attention calls on its
kernel route (``models.attention``).  ``flash_decode`` launches the CUDA
kernels (``csrc/flash_decode.cu``: one block per (batch row, kv head,
split of S), its warps each streaming K/V tiles through shared memory,
then a combine of the splits) on CUDA tensors and runs
``flash_decode_plain`` on CPU tensors.  Both follow a ``DecodePlan``
from ``decode_plan``.

Semantics are the Pallas wrapper's: q [B, H, D] pre-scaled, k/v
[B, S, KH, D], kv head = q head // (H / KH), positions at or past
``kv_len[b]`` masked, output ``o / max(l, 1e-20)`` as f32 [B, H, D], so a
row with ``kv_len == 0`` gives 0 (``flash_decode_ref``, a full softmax,
gives NaN there).  ``kv_len > S`` is not defined by the JAX wrapper; here
both versions read positions below ``min(kv_len, S)``.

On meta tensors (the dry run) ``flash_decode`` checks its inputs as on
the card, returns an empty output and hands ``decode_work`` to the work
counter, every row read to S (``kv_len`` has no values there); it
launches nothing and counts no launch.  ``decode_work`` is also the
bound that ``chip_smoke.py`` holds the kernel to.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, counters

__all__ = ["flash_decode", "flash_decode_plain", "decode_plan", "device_plan",
           "decode_work", "DecodePlan", "TILE", "NEG_INF", "MAX_HEAD_DIM"]

TILE = 16            # csrc/flash_decode.cu TILE: positions per warp tile
GROUP_MAX = 8        # csrc/flash_decode.cu GMAX: q heads per block
# A split pays a fixed cost (q into shared memory, its first tiles' load
# latency, the merge of its warps), so S is cut into at most S / 640
# splits (about 40 tiles each); below that the plan aims at about 12
# blocks per SM, since ragged rows leave many splits empty, rounded down
# to whole waves of the blocks that fit on the card at once.
MIN_SPLIT = 640
BLOCKS_PER_SM = 12
RESIDENT_PER_SM = 3  # split blocks per H100 SM at bf16, D 128 (CPU plans)
H100_SMS = 132
NEG_INF = -1e30
MAX_HEAD_DIM = 256   # csrc/flash_decode.cu MAX_D

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class DecodePlan(NamedTuple):
    """Split ``i`` covers positions ``[i * split_len, min((i + 1) *
    split_len, S))``; each split runs an online softmax over tiles of
    ``tile`` positions, and the splits' partials are merged at the end."""

    splits: int
    split_len: int
    tile: int


class _DecodeArgs(ctypes.Structure):
    """Mirror of ``DecodeArgs`` in csrc/flash_decode.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "kv_len", "o", "part_m", "part_l", "part_acc")]
        + [(n, ctypes.c_int) for n in ("B", "H", "KH", "S", "D", "dtype",
                                       "splits", "split_len")])


def decode_plan(b: int, h: int, kh: int, s: int, sms: int = H100_SMS,
                per_sm: int = RESIDENT_PER_SM) -> DecodePlan:
    """Cut S into splits so that B x KH x head groups x splits comes near
    ``BLOCKS_PER_SM`` blocks per SM (at B 1 as at B 16), into at most
    ``ceil(S / MIN_SPLIT)`` splits, each a whole number of tiles; a grid
    larger than one wave of ``per_sm`` resident blocks per SM is cut
    back to whole waves.  The plan depends on shapes only (never on
    ``kv_len``, which lives on the device); splits past a row's
    ``kv_len`` return at once."""
    if s <= 0:
        return DecodePlan(1, TILE, TILE)
    rows = b * kh * -(-(h // kh) // GROUP_MAX)
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // rows), -(-s // MIN_SPLIT)))
    wave = per_sm * sms
    if rows * splits > wave:
        splits = max(1, rows * splits // wave * wave // rows)
    split_len = -(-(-(-s // splits)) // TILE) * TILE
    return DecodePlan(-(-s // split_len), split_len, TILE)


def device_plan(q: torch.Tensor, k: torch.Tensor) -> DecodePlan:
    """The plan ``flash_decode`` takes by default for these CUDA inputs:
    ``decode_plan`` with the card's SMs and the split kernel's occupancy
    for k's dtype, D and the group size."""
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    return decode_plan(b, h, kh, s, *_card(q.device, k.dtype, d, h // kh))


def _card(device: torch.device, dtype: torch.dtype, d: int, group: int):
    key = (device.index, dtype, d, min(group, GROUP_MAX))
    if key not in _RESIDENT:
        fn = build.load("flash_decode").flash_decode_resident
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.check(fn(_DTYPES[dtype], d, group, ctypes.byref(n)),
                        "flash_decode occupancy")
        _RESIDENT[key] = (torch.cuda.get_device_properties(device)
                          .multi_processor_count, max(1, n.value))
    return _RESIDENT[key]


_RESIDENT: dict = {}


def decode_work(b: int, h: int, kh: int, s: int, d: int, itemsize: int,
                rows: Optional[int] = None) -> dict:
    """The least work of one decode attention: ``rows`` K/V positions
    read (the sum over the batch of ``min(kv_len, S)``; default every row
    full, B x S), each K and V row once in the cache's ``itemsize``, q
    and o in f32 (``bytes``); per position and q head a dot product with
    k and one with v (``flops_f32``, 4 D) and one exponential
    (``exps``)."""
    rows = b * s if rows is None else rows
    return {"bytes": rows * kh * d * itemsize * 2 + 2 * b * h * d * 4,
            "flops_f32": 4 * h * d * rows, "exps": h * rows}


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor,
                       plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """The kernel's algorithm in torch, vectorised over (b, kv head, q
    head of the group, split), on the inputs' device: per split, the
    Pallas body's online softmax tile by tile (the ``NEG_INF`` mask, the
    alpha guard while m is still ``NEG_INF``, masked p 0), giving
    unnormalised (acc, m, l); then the combine: ``o = sum_i w_i acc_i /
    max(sum_i w_i l_i, 1e-20)`` with ``w_i = 0`` where ``m_i`` is
    ``NEG_INF``, else ``exp(m_i - max m)``.  ``plan`` defaults to the
    kernel's (``device_plan``) on CUDA tensors and to ``decode_plan`` for
    the H100 on CPU tensors; a plan moves only the order of the sums.
    Returns f32 [B, H, D]."""
    f32 = torch.float32
    q = q.to(f32)
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError("GQA needs q heads to be a multiple of kv heads")
    group = h // kh
    dev = q.device
    if plan is None:
        plan = (device_plan(q, k) if dev.type == "cuda"
                else decode_plan(b, h, kh, s))
    splits, split_len, tile = plan
    if splits * split_len < s or tile <= 0:
        raise ValueError(f"{plan} does not cover S = {s}")
    qg = q.view(b, kh, group, 1, 1, d)
    starts = torch.arange(splits, device=dev) * split_len            # [P]
    ends = torch.minimum(torch.clamp(starts + split_len, max=s)[None, :],
                         kv_len.to(torch.int64)[:, None])             # [B, P]
    m = torch.full((b, kh, group, splits), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, kh, group, splits), dtype=f32, device=dev)
    acc = torch.zeros((b, kh, group, splits, d), dtype=f32, device=dev)
    for t0 in range(0, split_len if s else 0, tile):
        pos = starts[:, None] + t0 + torch.arange(tile, device=dev)   # [P, T]
        valid = (pos[None] < ends[:, :, None])[:, None, None]   # [B,1,1,P,T]
        idx = torch.clamp(pos, max=s - 1)
        kb = k[:, idx].to(f32).permute(0, 3, 1, 2, 4)[:, :, None]
        vb = v[:, idx].to(f32).permute(0, 3, 1, 2, 4)[:, :, None]
        scores = torch.sum(kb * qg, dim=-1)                  # [B,KH,G,P,T]
        scores = torch.where(valid, scores, NEG_INF)
        m_new = torch.maximum(m, scores.max(dim=-1).values)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
        p = torch.where(valid, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.sum(p[..., None] * vb, dim=-2)
        m = m_new
    w = torch.where(m == NEG_INF, 0.0,
                    torch.exp(m - m.max(dim=-1, keepdim=True).values))
    o = torch.sum(w[..., None] * acc, dim=-2)
    den = torch.clamp(torch.sum(w * l, dim=-1), min=1e-20)
    return (o / den[..., None]).reshape(b, h, d)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor,
                 plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """Decode attention -> f32 [B, H, D].

    q: [B, H, D] float (cast to f32 here, as the JAX wrapper does);
    k, v: [B, S, KH, D] of one dtype (f32, bf16 or f16), read in that
    dtype; kv_len: i32[B]; all contiguous on one device, D <= 256 and
    H a multiple of KH.  ``plan`` defaults to ``decode_plan`` for the
    card and the kernel's occupancy; the kernel takes tiles of ``TILE``
    only.  CUDA tensors launch ``csrc/flash_decode.cu`` (and count the
    call); CPU tensors run ``flash_decode_plain``; meta tensors count
    ``decode_work``."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len, plan)
    if q.device.type not in ("cuda", "meta"):
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
    if q.device.type == "meta":
        counters.count_work("flash_decode", decode_work(
            b, h, kh, s, d, k.element_size()))
        return torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if plan is None:
        plan = device_plan(q, k)
    if plan.tile != TILE or plan.split_len % TILE \
            or plan.splits * plan.split_len < s:
        raise ValueError(f"the kernel takes tiles of {TILE} and splits that "
                         f"cover S; got {plan}")
    o = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o
    q32 = q.to(torch.float32).contiguous()
    n = b * h * plan.splits
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    a = _DecodeArgs()
    a.q, a.k, a.v = q32.data_ptr(), k.data_ptr(), v.data_ptr()
    a.kv_len, a.o = kv_len.data_ptr(), o.data_ptr()
    a.part_m, a.part_l = part.data_ptr(), part[n:].data_ptr()
    a.part_acc = part[2 * n:].data_ptr()
    a.B, a.H, a.KH, a.S, a.D = b, h, kh, s, d
    a.dtype = _DTYPES[k.dtype]
    a.splits, a.split_len = plan.splits, plan.split_len
    fn = build.load("flash_decode").flash_decode_launch
    fn.argtypes = [ctypes.POINTER(_DecodeArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(ctypes.byref(a), build.stream_ptr(q.device)),
                "flash_decode")
    counters.launched(flash_decode)
    return o


flash_decode.launches = 0
