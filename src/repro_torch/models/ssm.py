"""State-space block: Mamba1 (selective scan), prefill and decode.

Port of ``repro.models.ssm`` for ``SSMConfig.version == 1`` (Mamba2 is
zamba2's block and ports with ROADMAP A15b).  ``mamba_block`` is the
prefill: under ``use_scan_kernel`` the selective scan is one
``ops.mamba_scan`` call (``csrc/mamba_scan.cu`` on the card, its plain
version on CPU tensors), and the launcher serves through it; otherwise
the chunked path runs in plain PyTorch: a scan by doubling inside each
chunk of ``s.chunk`` steps, the state carried across chunks, so live
memory is one chunk's [B, chunk, d_inner, N] tensors.  The chunked path
is kept as the kernel branch's reference (the JAX parity tests and the
card smoke compare the two).  Decode is the exact one-token recurrence.

The JAX module's sharding hints (``constrain``) and ``mamba_specs`` have
no counterpart on one card (ROADMAP A15b).  Its ``remat_chunks``
argument is dropped: the port runs forward only, so nothing is kept for
a backward pass.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Initializer

__all__ = ["init_mamba", "mamba_block", "mamba_scan_inputs",
           "mamba_decode_step", "init_ssm_state"]

_F32 = torch.float32


def _dt_rank(d_model: int, s: SSMConfig) -> int:
    return s.dt_rank or max(d_model // 16, 1)


def _check_version(s: SSMConfig) -> None:
    if s.version != 1:
        raise NotImplementedError(
            "Mamba2 (SSMConfig.version 2, zamba2's block) is not ported to "
            "repro_torch yet (ROADMAP A15b)")


def init_mamba(init: Initializer, d_model: int, s: SSMConfig
               ) -> Dict[str, torch.Tensor]:
    """One Mamba1 layer's parameters, with the JAX package's shapes,
    stddevs and dtypes (``dt_bias``, ``A_log`` and ``D`` in f32)."""
    _check_version(s)
    di = s.expand * d_model
    dtr = _dt_rank(d_model, s)
    a_log = torch.log(torch.arange(1, s.state_dim + 1, dtype=_F32,
                                   device=init.device))
    return {
        "w_in": init.normal((d_model, 2 * di), d_model ** -0.5),
        "conv_w": init.normal((s.conv_width, di), 0.2),
        "conv_b": init.zeros((di,)),
        "w_out": init.normal((di, d_model), di ** -0.5),
        "w_bc": init.normal((di, 2 * s.state_dim), di ** -0.5),
        "w_dt_down": init.normal((di, dtr), di ** -0.5),
        "w_dt_up": init.normal((dtr, di), dtr ** -0.5),
        "dt_bias": init.normal((di,), 0.1).to(_F32),
        "A_log": a_log.repeat(di, 1),
        "D": init.ones((di,)).to(_F32),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time, as a sum of shifted products (no
    cuDNN convolution, which runs f32 in TF32 by default).
    x [B, L, C]; w [K, C]."""
    k = w.shape[0]
    if init_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_state
    xp = torch.cat([pad, x], dim=1)
    l = x.shape[1]
    out = xp[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + l] * w[i]
    return out + b


def _scan_chunk(a_bar: torch.Tensor, bx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 by doubling:
    returns (prod a_1..t, h_t from h_0 = 0) for every t of the chunk."""
    c = a_bar.shape[1]
    step = 1
    while step < c:
        a_prev, b_prev = a_bar[:, :-step], bx[:, :-step]
        a_cur, b_cur = a_bar[:, step:], bx[:, step:]
        a_bar = torch.cat([a_bar[:, :step], a_prev * a_cur], dim=1)
        bx = torch.cat([bx[:, :step], a_cur * b_prev + b_cur], dim=1)
        step *= 2
    return a_bar, bx


def _chunked_scan(dt, xi, b_in, c_out, a, chunk: int) -> torch.Tensor:
    """The JAX package's chunked selective scan: ``max(L // chunk, 1)``
    chunks of ``L // nchunks`` steps (L must divide evenly, as there)."""
    b, l, di = dt.shape
    nchunks = max(l // chunk, 1)
    c = l // nchunks
    if nchunks * c != l:
        raise ValueError(f"chunked scan: L={l} is not {nchunks} chunks of "
                         f"{c} (as in the JAX package)")
    h_prev = torch.zeros((b, di, a.shape[1]), dtype=_F32, device=dt.device)
    ys = []
    for i in range(nchunks):
        sl = slice(i * c, (i + 1) * c)
        dt_c, xi_c, b_c, cout_c = dt[:, sl], xi[:, sl], b_in[:, sl], \
            c_out[:, sl]
        a_bar = torch.exp(dt_c[..., None] * a)              # [B, c, di, N]
        bx = (dt_c * xi_c)[..., None] * b_c[:, :, None, :]
        pa, pb = _scan_chunk(a_bar, bx)
        h = pa * h_prev[:, None] + pb
        ys.append(torch.einsum("bcdn,bcn->bcd", h, cout_c))
        h_prev = h[:, -1]
    return torch.cat(ys, dim=1)


def mamba_scan_inputs(x: torch.Tensor, p: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
    """The selective scan's inputs as ``mamba_block`` makes them from
    x [B, L, D]: (dt, xi, b_in, c_out), contiguous f32, and the gate z in
    x's dtype.  The dt projection runs in the compute dtype, then
    softplus, then the cast to f32, as in the JAX package."""
    dtype = x.dtype
    xz = x @ p["w_in"]
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xi = F.silu(xi.to(_F32)).to(dtype)
    bc = xi @ p["w_bc"]
    b_in, c_out = (t.contiguous() for t in torch.chunk(bc.to(_F32), 2,
                                                       dim=-1))
    dt = F.softplus((xi @ p["w_dt_down"]) @ p["w_dt_up"]
                    + p["dt_bias"].to(dtype)).to(_F32)       # [B, L, di]
    return dt, xi.to(_F32), b_in, c_out, z


def mamba_block(x: torch.Tensor, p: Dict[str, torch.Tensor], d_model: int,
                s: SSMConfig) -> torch.Tensor:
    """Prefill forward. x [B, L, D] -> [B, L, D]."""
    _check_version(s)
    dtype = x.dtype
    dt, xi32, b_in, c_out, z = mamba_scan_inputs(x, p)
    if s.use_scan_kernel:
        y = kops.mamba_scan(dt, xi32, b_in, c_out, p["A_log"])
    else:
        a = -torch.exp(p["A_log"])                           # [di, N]
        y = _chunked_scan(dt, xi32, b_in, c_out, a, s.chunk)
    y = y + p["D"] * xi32
    y = y.to(dtype) * F.silu(z.to(_F32)).to(dtype)
    return y @ p["w_out"]


def init_ssm_state(batch: int, d_model: int, s: SSMConfig,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    _check_version(s)
    di = s.expand * d_model
    return {"h": torch.zeros((batch, di, s.state_dim), dtype=_F32,
                             device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, di), dtype=dtype,
                                device=device)}


def mamba_decode_step(x: torch.Tensor, state: Dict[str, torch.Tensor],
                      p: Dict[str, torch.Tensor], d_model: int,
                      s: SSMConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence. x [B, 1, D]; returns (y [B, 1, D], new
    state); the given state is not modified."""
    _check_version(s)
    dtype = x.dtype
    xz = x @ p["w_in"]
    xi, z = torch.chunk(xz, 2, dim=-1)                       # [B, 1, di]
    conv_buf = torch.cat([state["conv"], xi], dim=1)         # [B, K, di]
    xi = (conv_buf * p["conv_w"][None]).sum(dim=1, keepdim=True) \
        + p["conv_b"]
    xi = F.silu(xi.to(_F32)).to(dtype)
    new_conv = conv_buf[:, 1:]
    bc = xi @ p["w_bc"]
    b_in, c_out = torch.chunk(bc.to(_F32), 2, dim=-1)
    dt = F.softplus((xi @ p["w_dt_down"]) @ p["w_dt_up"]
                    + p["dt_bias"].to(dtype)).to(_F32)[:, 0]  # [B, di]
    a = -torch.exp(p["A_log"])
    a_bar = torch.exp(dt[..., None] * a)                     # [B, di, N]
    xi0 = xi[:, 0].to(_F32)
    bx = (dt * xi0)[..., None] * b_in[:, 0, None, :]
    h = a_bar * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, c_out[:, 0])
    y = y + p["D"] * xi0
    y = y[:, None].to(dtype) * F.silu(z.to(_F32)).to(dtype)
    return y @ p["w_out"], {"h": h, "conv": new_conv}
