"""Numerical-NF inference kernel: feats f32[B, d] -> transformed keys f32[B].

Port of ``repro.kernels.nf_forward``.  ``nf_forward`` launches the CUDA
kernel (``csrc/nf_forward.cu``) on CUDA tensors and runs
``nf_forward_plain`` on CPU tensors; there is no other route.  Both
compute ``apply_flow_tile``'s arithmetic in its order — standardize by
(mu, 1/sd), the unrolled dense layers with tanh on all but the last,
then the sum-decode ``z = sum_k h_k * out_scale_k`` — with one rounding
per multiply and per add.
"""

from __future__ import annotations

import collections
import ctypes
from collections import OrderedDict
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build, counters

__all__ = ["pack_flow_weights", "nf_forward", "nf_forward_plain",
           "nf_params", "nf_params_cached"]

Shapes = Tuple[Tuple[int, int], ...]


def pack_flow_weights(weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      out_scale: torch.Tensor, feat_mu: torch.Tensor,
                      feat_sd: torch.Tensor) -> Tuple[torch.Tensor, Shapes]:
    """Flatten effective layer weights into one f32 row [1, n] on the CPU.

    Layout: mu(d) | sd_inv(d) | per-layer [W(row-major out x in) | b] |
    out_scale(d); ``layer_shapes[i] = (out_width, in_width)``.  The row
    lives on the host because the kernels take it as a launch argument.
    """
    parts = [feat_mu.reshape(-1), (1.0 / feat_sd).reshape(-1)]
    shapes = []
    for w, b in weights:
        shapes.append((int(w.shape[0]), int(w.shape[1])))
        parts.append(w.reshape(-1))
        parts.append(b.reshape(-1))
    parts.append(out_scale.reshape(-1))
    packed = torch.cat([p.detach().to("cpu", torch.float32) for p in parts])
    return packed.reshape(1, -1), tuple(shapes)


def nf_params(packed_w: torch.Tensor, shapes: Shapes,
              dim: int) -> build.NFParams:
    """The kernels' by-value weight argument for one packed flow."""
    if packed_w.device.type != "cpu":
        raise ValueError("packed_w must live on the CPU (a launch argument)")
    flat = packed_w.reshape(-1).to(torch.float32)
    n_w = int(flat.numel())
    if len(shapes) > build.NF_MAX_LAYERS or n_w > build.NF_MAX_W:
        raise ValueError(
            f"flow too large for the kernel argument: {len(shapes)} layers "
            f"(max {build.NF_MAX_LAYERS}), {n_w} weights "
            f"(max {build.NF_MAX_W})")
    if max([dim] + [max(s) for s in shapes]) > 32:
        raise ValueError("flow layer width exceeds 32")
    p = build.NFParams()
    p.dim = dim
    p.n_layers = len(shapes)
    for i, (n_out, n_in) in enumerate(shapes):
        p.n_out[i] = n_out
        p.n_in[i] = n_in
    p.n_w = n_w
    ctypes.memmove(p.w, flat.contiguous().numpy().ctypes.data, 4 * n_w)
    return p


_PARAMS: "OrderedDict[tuple, tuple]" = OrderedDict()
_PARAMS_KEEP = 4


def nf_params_cached(packed_w: torch.Tensor, shapes: Shapes,
                     dim: int) -> build.NFParams:
    """``nf_params`` built once per packed-weights tensor: keyed by its
    ``data_ptr()`` and ``_version`` (an in-place change rebuilds it), its
    length, the shapes and dim.  The cache holds the tensor, so its
    address is not reused while its entry lives; the last few entries
    are kept."""
    key = (packed_w.data_ptr(), packed_w._version, packed_w.numel(),
           tuple(shapes), dim)
    hit = _PARAMS.get(key)
    if hit is None:
        hit = (packed_w, nf_params(packed_w, shapes, dim))
        _PARAMS[key] = hit
        while len(_PARAMS) > _PARAMS_KEEP:
            _PARAMS.popitem(last=False)
    else:
        _PARAMS.move_to_end(key)
    return hit[1]


def nf_forward_plain(feats: torch.Tensor, packed_w: torch.Tensor,
                     shapes: Shapes, dim: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel on ``feats``' device: the same
    operations in the same order, one elementwise op each."""
    w = packed_w.reshape(-1).to(device=feats.device, dtype=torch.float32)
    feats = feats.to(torch.float32)
    idx = 0

    def rd(n):
        nonlocal idx
        vals = [w[idx + i] for i in range(n)]
        idx += n
        return vals

    mu = rd(dim)
    sd_inv = rd(dim)
    h = [(feats[:, k] - mu[k]) * sd_inv[k] for k in range(dim)]
    n_layers = len(shapes)
    for li, (n_out, n_in) in enumerate(shapes):
        wl = rd(n_out * n_in)
        b = rd(n_out)
        new_h = []
        for j in range(n_out):
            acc = b[j] + h[0] * wl[j * n_in]
            for k in range(1, n_in):
                acc = acc + h[k] * wl[j * n_in + k]
            if li < n_layers - 1:
                acc = torch.tanh(acc)
            new_h.append(acc)
        h = new_h
    out_scale = rd(dim)
    z = h[0] * out_scale[0]
    for k in range(1, dim):
        z = z + h[k] * out_scale[k]
    return z


def nf_forward(feats: torch.Tensor, packed_w: torch.Tensor, shapes: Shapes,
               dim: int) -> torch.Tensor:
    """feats f32[B, dim] -> z f32[B] on ``feats``' device.

    CUDA tensors launch ``csrc/nf_forward.cu`` (and count the launch, by
    batch size too); CPU tensors run ``nf_forward_plain``.  ``packed_w``
    is the CPU row from ``pack_flow_weights``.  Any contiguous ``feats``
    is served; a 16-byte aligned one with the default flow takes the
    kernel's four-keys-a-thread path."""
    if feats.device.type == "cpu":
        return nf_forward_plain(feats, packed_w, shapes, dim)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype != torch.float32 or feats.dim() != 2 \
            or feats.shape[1] != dim or not feats.is_contiguous():
        raise ValueError("feats must be contiguous f32[B, dim]")
    params = nf_params_cached(packed_w, shapes, dim)
    fn = build.function("nf_forward", "nf_forward_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.POINTER(build.NFParams), ctypes.c_void_p])
    b = int(feats.shape[0])
    out = torch.empty(b, dtype=torch.float32, device=feats.device)
    if b == 0:
        return out
    build.check(fn(feats.data_ptr(), out.data_ptr(), b, ctypes.byref(params),
                   build.stream_ptr(feats.device)), "nf_forward")
    counters.launched(nf_forward, b)
    return out


nf_forward.launches = 0
nf_forward.launch_sizes = collections.Counter()   # batch size -> launches
