"""State-space blocks: Mamba1 (selective scan) and Mamba2 (SSD chunked
dual), prefill and decode.

Port of ``repro.models.ssm``.  Mamba1 (``SSMConfig.version == 1``,
falcon-mamba-7b): ``mamba_block`` is the prefill; under
``use_scan_kernel`` the selective scan is one ``ops.mamba_scan`` call
(``csrc/mamba_scan.cu`` on the card, its plain version on CPU tensors),
and the launcher serves through it; otherwise the chunked path runs in
plain PyTorch: a scan by doubling inside each chunk of ``s.chunk``
steps, the state carried across chunks, so live memory is one chunk's
[B, chunk, d_inner, N] tensors.  The chunked path is kept as the kernel
branch's reference (the JAX parity tests and the card smoke compare the
two).  Mamba2 (``version == 2``, zamba2-2.7b's block) has only the
chunked path, as in JAX (``use_scan_kernel`` is Mamba1's): per head a
scalar decay, the state [B, H, head_dim, N] carried across chunks, and
``gate_norm`` (an RMS norm) after the gate.  Decode is the exact
one-token recurrence on both versions.

Training differentiates the chunked paths.  ``remat_chunks`` (the
transformer passes ``cfg.remat != "none"``) recomputes each chunk's
[B, chunk, d_inner, N] tensors in the backward pass, as the JAX chunk
body's ``jax.checkpoint`` does.  ``mamba_scan`` has no backward kernel
(the Pallas kernel has none either), so ``use_scan_kernel`` under
autograd raises on every device rather than differentiate the plain
version.  ``mamba_specs`` is the JAX table of logical axes
(``d_inner`` over ``model`` unless ``batch_tp``); the mesh runs the
dense family only, so the JAX module's sharding hints (``constrain``)
have no counterpart yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Initializer, checkpointed, rms_norm

__all__ = ["init_mamba", "mamba_specs", "mamba_block", "mamba_scan_inputs",
           "mamba_decode_step", "init_ssm_state"]

_F32 = torch.float32


def _dt_rank(d_model: int, s: SSMConfig) -> int:
    return s.dt_rank or max(d_model // 16, 1)


def init_mamba(init: Initializer, d_model: int, s: SSMConfig
               ) -> Dict[str, torch.Tensor]:
    """One Mamba layer's parameters, with the JAX package's shapes,
    stddevs and dtypes (``dt_bias``, ``A_log`` and ``D`` in f32)."""
    di = s.expand * d_model
    p = {
        "w_in": init.normal((d_model, 2 * di), d_model ** -0.5),
        "conv_w": init.normal((s.conv_width, di), 0.2),
        "conv_b": init.zeros((di,)),
        "w_out": init.normal((di, d_model), di ** -0.5),
    }
    if s.version == 1:
        dtr = _dt_rank(d_model, s)
        a_log = torch.log(torch.arange(1, s.state_dim + 1, dtype=_F32,
                                       device=init.device))
        p.update({
            "w_bc": init.normal((di, 2 * s.state_dim), di ** -0.5),
            "w_dt_down": init.normal((di, dtr), di ** -0.5),
            "w_dt_up": init.normal((dtr, di), dtr ** -0.5),
            "dt_bias": init.normal((di,), 0.1).to(_F32),
            "A_log": a_log.repeat(di, 1),
            "D": init.ones((di,)).to(_F32),
        })
    else:
        nh = di // s.head_dim
        p.update({
            "w_bc": init.normal((d_model, 2 * s.state_dim), d_model ** -0.5),
            "w_dt": init.normal((d_model, nh), d_model ** -0.5),
            "dt_bias": init.normal((nh,), 0.1).to(_F32),
            "A_log": torch.zeros((nh,), dtype=_F32, device=init.device),
            "D": init.ones((nh,)).to(_F32),
            "gate_norm": init.zeros((di,)),
        })
    return p


def mamba_specs(d_model: int, s: SSMConfig):
    """Logical axes of ``init_mamba``'s leaves (JAX ``mamba_specs``)."""
    di_ax = None if s.batch_tp else "d_inner"
    base = {
        "w_in": ("fsdp", di_ax),
        "conv_w": (None, di_ax),
        "conv_b": (di_ax,),
        "w_out": (di_ax, "fsdp"),
    }
    if s.version == 1:
        base.update({
            "w_bc": (di_ax, None),
            "w_dt_down": (di_ax, None),
            "w_dt_up": (None, di_ax),
            "dt_bias": (di_ax,),
            "A_log": (di_ax, None),
            "D": (di_ax,),
        })
    else:
        base.update({
            "w_bc": ("fsdp", None),
            "w_dt": ("fsdp", None),
            "dt_bias": (None,),
            "A_log": (None,),
            "D": (None,),
            "gate_norm": (di_ax,),
        })
    return base


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


def _chunk_sizes(l: int, chunk: int) -> Tuple[int, int]:
    """The JAX chunking: ``max(L // chunk, 1)`` chunks of ``L // nchunks``
    steps; L must split evenly, as there (the JAX reshape raises)."""
    nchunks = max(l // chunk, 1)
    c = l // nchunks
    if nchunks * c != l:
        raise ValueError(f"chunked scan: L={l} is not {nchunks} chunks of "
                         f"{c} (as in the JAX package)")
    return nchunks, c


def _chunk1(h_prev, dt_c, xi_c, b_c, cout_c, a):
    a_bar = torch.exp(dt_c[..., None] * a)                  # [B, c, di, N]
    bx = (dt_c * xi_c)[..., None] * b_c[:, :, None, :]
    pa, pb = _scan_chunk(a_bar, bx)
    h = pa * h_prev[:, None] + pb
    return h[:, -1], torch.einsum("bcdn,bcn->bcd", h, cout_c)


def _run_chunks(body, h_prev, xs, c: int, remat_chunks: bool):
    """``body`` over the chunks of the [B, L, ...] inputs ``xs`` (then its
    constant last argument), the state carried; each chunk recomputed in
    the backward pass when ``remat_chunks``."""
    *seq, const = xs
    ys = []
    for i in range(seq[0].shape[1] // c):
        sl = slice(i * c, (i + 1) * c)
        args = (h_prev, *(t[:, sl] for t in seq), const)
        h_prev, y = (checkpointed(body, *args) if remat_chunks
                     else body(*args))
        ys.append(y)
    return torch.cat(ys, dim=1)


def _chunked_scan(dt, xi, b_in, c_out, a, chunk: int,
                  remat_chunks: bool = False) -> torch.Tensor:
    """The JAX package's chunked selective scan: ``max(L // chunk, 1)``
    chunks of ``L // nchunks`` steps (L must divide evenly, as there)."""
    b, l, di = dt.shape
    _nchunks, c = _chunk_sizes(l, chunk)
    h0 = torch.zeros((b, di, a.shape[1]), dtype=_F32, device=dt.device)
    return _run_chunks(_chunk1, h0, (dt, xi, b_in, c_out, a), c,
                       remat_chunks)


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


def _chunk2(h_prev, dt_c, xh_c, b_c, cout_c, a):
    a_bar = torch.exp(dt_c * a)                               # [B, c, H]
    bx = (dt_c[..., None] * xh_c)[..., None] \
        * b_c[:, :, None, None, :]                            # [B,c,H,P,N]
    pa, pb = _scan_chunk(a_bar[..., None, None], bx)
    h = pa * h_prev[:, None] + pb
    return h[:, -1], torch.einsum("bchdn,bcn->bchd", h, cout_c)


def _chunked_scan2(dt, xh, b_in, c_out, a, chunk: int,
                   remat_chunks: bool = False) -> torch.Tensor:
    """Mamba2's chunked SSD: dt [B, L, H], xh [B, L, H, P], b_in / c_out
    [B, L, N], a [H] -> y [B, L, H, P]; per chunk the scan by doubling of
    h_t = exp(dt a) h_{t-1} + dt x_t b_t^T, the state carried across."""
    b, l, nh, hd = xh.shape
    _nchunks, c = _chunk_sizes(l, chunk)
    h0 = torch.zeros((b, nh, hd, b_in.shape[-1]), dtype=_F32,
                     device=xh.device)
    return _run_chunks(_chunk2, h0, (dt, xh, b_in, c_out, a), c,
                       remat_chunks)


def _no_scan_backward(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> None:
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in p.values())):
        raise NotImplementedError(
            "mamba_scan has no backward kernel (csrc/mamba_scan.cu and its "
            "plain version are forward only, as the Pallas kernel is): "
            "train with SSMConfig.use_scan_kernel=False")


def mamba_block(x: torch.Tensor, p: Dict[str, torch.Tensor], d_model: int,
                s: SSMConfig, remat_chunks: bool = False) -> torch.Tensor:
    """Prefill and training forward. x [B, L, D] -> [B, L, D]."""
    dtype = x.dtype
    if s.version == 1:
        if s.use_scan_kernel:
            _no_scan_backward(x, p)
        dt, xi32, b_in, c_out, z = mamba_scan_inputs(x, p)
        if s.use_scan_kernel:
            y = kops.mamba_scan(dt, xi32, b_in, c_out, p["A_log"])
        else:
            a = -torch.exp(p["A_log"])                       # [di, N]
            y = _chunked_scan(dt, xi32, b_in, c_out, a, s.chunk,
                              remat_chunks)
        y = y + p["D"] * xi32
        y = y.to(dtype) * F.silu(z.to(_F32)).to(dtype)
        return y @ p["w_out"]
    b, l, _ = x.shape
    di = s.expand * d_model
    nh = di // s.head_dim
    xz = x @ p["w_in"]
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xi = F.silu(xi.to(_F32)).to(dtype)
    bc = x @ p["w_bc"]
    b_in, c_out = torch.chunk(bc.to(_F32), 2, dim=-1)         # [B, L, N]
    dt = F.softplus((x @ p["w_dt"]).to(_F32) + p["dt_bias"])  # [B, L, H]
    a = -torch.exp(p["A_log"])                                # [H]
    xh = xi.reshape(b, l, nh, s.head_dim).to(_F32)
    y = _chunked_scan2(dt, xh, b_in, c_out, a, s.chunk, remat_chunks)
    y = y + p["D"][:, None] * xh
    y = y.reshape(b, l, di).to(dtype)
    y = rms_norm(y * F.silu(z.to(_F32)).to(dtype), p["gate_norm"])
    return y @ p["w_out"]


def init_ssm_state(batch: int, d_model: int, s: SSMConfig,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    di = s.expand * d_model
    if s.version == 1:
        h_shape = (batch, di, s.state_dim)
    else:
        h_shape = (batch, di // s.head_dim, s.head_dim, s.state_dim)
    return {"h": torch.zeros(h_shape, dtype=_F32, device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, di), dtype=dtype,
                                device=device)}


def mamba_decode_step(x: torch.Tensor, state: Dict[str, torch.Tensor],
                      p: Dict[str, torch.Tensor], d_model: int,
                      s: SSMConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence. x [B, 1, D]; returns (y [B, 1, D], new
    state); the given state is not modified."""
    b = x.shape[0]
    dtype = x.dtype
    di = s.expand * d_model
    xz = x @ p["w_in"]
    xi, z = torch.chunk(xz, 2, dim=-1)                       # [B, 1, di]
    conv_buf = torch.cat([state["conv"], xi], dim=1)         # [B, K, di]
    xi = (conv_buf * p["conv_w"][None]).sum(dim=1, keepdim=True) \
        + p["conv_b"]
    xi = F.silu(xi.to(_F32)).to(dtype)
    new_conv = conv_buf[:, 1:]
    if s.version == 1:
        bc = xi @ p["w_bc"]
        b_in, c_out = torch.chunk(bc.to(_F32), 2, dim=-1)
        dt = F.softplus((xi @ p["w_dt_down"]) @ p["w_dt_up"]
                        + p["dt_bias"].to(dtype)).to(_F32)[:, 0]  # [B, di]
        a = -torch.exp(p["A_log"])
        a_bar = torch.exp(dt[..., None] * a)                 # [B, di, N]
        xi0 = xi[:, 0].to(_F32)
        bx = (dt * xi0)[..., None] * b_in[:, 0, None, :]
        h = a_bar * state["h"] + bx
        y = torch.einsum("bdn,bn->bd", h, c_out[:, 0])
        y = y + p["D"] * xi0
        y = y[:, None].to(dtype) * F.silu(z.to(_F32)).to(dtype)
        return y @ p["w_out"], {"h": h, "conv": new_conv}
    nh = di // s.head_dim
    bc = x @ p["w_bc"]
    b_in, c_out = torch.chunk(bc.to(_F32), 2, dim=-1)        # [B, 1, N]
    dt = F.softplus((x @ p["w_dt"]).to(_F32) + p["dt_bias"])[:, 0]  # [B, H]
    a = -torch.exp(p["A_log"])
    a_bar = torch.exp(dt * a)                                # [B, H]
    xh = xi[:, 0].reshape(b, nh, s.head_dim).to(_F32)
    bx = (dt[..., None] * xh)[..., None] * b_in[:, 0, None, None, :]
    h = a_bar[..., None, None] * state["h"] + bx
    y = torch.einsum("bhdn,bn->bhd", h, c_out[:, 0])
    y = y + p["D"][:, None] * xh
    y = y.reshape(b, 1, di).to(dtype)
    y = rms_norm(y * F.silu(z.to(_F32)).to(dtype), p["gate_norm"])
    return y @ p["w_out"], {"h": h, "conv": new_conv}
