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
(``d_inner`` over ``model`` unless ``batch_tp``).

**On a mesh** (``ctx``, an ``SSMMesh``; ``local_mamba`` gives the
weights a rank computes with), a layer runs on a rank's block of
``d_inner`` (the channels are independent through the conv and the
scan).  ``w_in`` is ``[D, 2 di]``
  with ``d_inner`` on the flat ``2 di`` axis, so rank r of ``model`` m
  stores the flat columns ``[r 2di/m, (r+1) 2di/m)``: at m = 2 rank 0
holds all of ``xi`` and rank 1 all of ``z``.  The block projects with
its stored columns and then moves the activation (one uneven all-to-all
over ``model``, ``tensor_parallel.exchange``) so that each rank holds
its channels of both ``xi`` and ``z``; no weight is gathered over
``model``.  Mamba1's ``w_bc`` and ``w_dt_down`` rows are channel
blocks, so ``bc`` and the low-rank ``dt`` are partial sums, summed over
``model`` and entering the channels again through ``copy_to``.
Mamba2's ``w_bc``, ``w_dt``, ``dt_bias``, ``A_log`` and ``D`` are
replicated: a rank takes its heads' entries (the rule ``inner_splits``
checks: its ``di/m`` channels are whole heads), and their gradients sum
over ``model``; ``gate_norm``'s mean square spans all of ``d_inner``
(``layers.tp_rms_norm``).  ``w_out``'s partial sums leave through
``reduce_from``.  The decode state ``ssm_h`` and ``ssm_conv`` hold the
rank's channels.

``batch_tp`` (the JAX ``"batch_model"`` rows over ``("pod", "data",
"model")``, ``d_inner`` unsplit; ``SSMMesh(layout="rows")``): the
weights are gathered over ``fsdp`` and nothing of them is split over
``model``.  A prefill or training layer takes the rank's block of its
data rank's rows (``tensor_parallel.scatter``: a slice, its gradient
gathered), runs the meshless block on them with whole weights (each
entering through ``copy_to``, so their gradients sum over ``model``),
and gathers the rows over ``model`` on exit (``gather``, its gradient
the rank's block).  Where a data rank's rows do not split over
``model`` (a microbatch of one row), every ``model`` rank runs them all.
The decode step keeps the JAX decode state's layout, ``ssm_h`` and
``ssm_conv`` over ``d_inner`` (``transformer.decode_state_specs``): the
rank decodes its ``d_inner`` block against the whole weights, cut to
its channels with no exchange (``layout="paired"``: its ``xi`` and
``z`` columns taken apart), the partial sums as on a ``d_inner``
block.  A decode batch need not split over ``model`` (decode_32k's 8
rows a data rank do not split 16 ways), and a decode step's cost is
the weights' read, not the rows, so the state does not follow the
rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (Initializer, checkpointed, rms_norm,
                                       tp_rms_norm)

__all__ = ["init_mamba", "mamba_specs", "mamba_block", "mamba_scan_inputs",
           "mamba_decode_step", "init_ssm_state", "SSMMesh",
           "inner_splits", "local_mamba", "pair_plan"]

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


# ====================================================================== mesh
@dataclasses.dataclass(frozen=True)
class SSMMesh:
    """A Mamba layer on ``mesh`` (see the module docstring): ``"inner"``
    a rank's ``d_inner`` block of the stored columns, moved by the
    exchange; ``"rows"`` (``batch_tp``) whole weights on the rank's
    block of rows, a decode step on its ``d_inner`` block of them;
    ``"paired"`` weights already cut to the rank's channels (``xi``'s
    block, then ``z``'s)."""
    mesh: Any
    layout: str = "inner"


_MAMBA2_REPLICATED = ("w_dt", "dt_bias", "A_log", "D")


def inner_splits(d_model: int, s: SSMConfig, mesh) -> bool:
    """Whether a layer runs on each rank's ``d_inner`` block: ``model``
    > 1, ``d_inner`` divides by ``model`` (so every
    ``d_inner`` leaf is split, ``guarded_spec``), and for Mamba2 a rank's
    ``d_inner / model`` channels are whole heads (``head_dim`` divides
    them)."""
    m = tp.axis_size(mesh, "model")
    di = s.expand * d_model
    if m == 1 or di % m:
        return False
    return s.version == 1 or (di // m) % s.head_dim == 0


def _narrow(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The block of ``x`` along ``dim`` rank ``model`` index stores."""
    m = tp.axis_size(mesh, "model")
    n = x.shape[dim] // m
    return x.narrow(dim, tp.axis_index(mesh, "model") * n, n)


def local_mamba(p: Dict[str, torch.Tensor], shardings, s: SSMConfig,
                mesh, inner: bool) -> Dict[str, torch.Tensor]:
    """The weights a rank computes a layer with, from its local shards
    ``p`` placed by ``shardings``: every ``fsdp`` block gathered (its
    gradient summed back over the data axes).  ``inner``: the
    ``d_inner`` blocks kept, and Mamba2's replicated leaves through
    ``copy_to`` (their gradients sum over ``model``), cut to the rank's
    heads; else whole weights."""
    keep = ("model",) if inner else ()
    w = {k: tp.materialize(x, shardings[k].spec, mesh, keep)
         for k, x in p.items()}
    if inner and s.version == 2:
        for k in ("w_bc",) + _MAMBA2_REPLICATED:
            w[k] = tp.copy_to(w[k], mesh, "model")
        for k in _MAMBA2_REPLICATED:
            w[k] = _narrow(w[k], w[k].dim() - 1, mesh)
    return w


def _channels(p: Dict[str, torch.Tensor], s: SSMConfig, mesh
              ) -> Dict[str, torch.Tensor]:
    """Whole weights cut to rank ``model``'s block of ``d_inner``: its
    ``xi`` and ``z`` columns of ``w_in`` side by side, every other
    ``d_inner`` dimension (``mamba_specs`` without ``batch_tp``) its
    block, and Mamba2's per-head leaves its heads'."""
    di = p["conv_b"].shape[0]
    r = tp.axis_index(mesh, "model")
    n = di // tp.axis_size(mesh, "model")
    specs = mamba_specs(0, dataclasses.replace(s, batch_tp=False))
    out = {}
    for k, x in p.items():
        if k == "w_in":
            x = torch.cat([x[:, r * n:(r + 1) * n],
                           x[:, di + r * n:di + (r + 1) * n]], dim=1)
        elif k in _MAMBA2_REPLICATED and s.version == 2:
            x = _narrow(x, x.dim() - 1, mesh)
        elif "d_inner" in specs[k]:
            x = _narrow(x, specs[k].index("d_inner"), mesh)
        out[k] = x
    return out


def _pair_channels(xz: torch.Tensor, mesh) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(xi, z), each [..., di/m], of the rank's flat block xz [..., 2di/m]
    of ``x @ w_in``.  The flat axis is 2m sub-blocks of di/m channels
    (``xi``'s m, then ``z``'s); rank j holds sub-blocks 2j and 2j+1, and
    sub-block q belongs to rank q mod m: one uneven all-to-all over
    ``model``.  Rank r receives its ``xi`` from rank r // 2 and its
    ``z`` from rank (m + r) // 2, in that order."""
    m = tp.axis_size(mesh, "model")
    if m == 1:
        return torch.chunk(xz, 2, dim=-1)
    w = xz.shape[-1] // 2
    swap, send, recv = pair_plan(m, tp.axis_index(mesh, "model"))
    if swap:
        xz = torch.cat([xz[..., w:], xz[..., :w]], dim=-1)
    got = tp.exchange(xz, xz.dim() - 1, [n * w for n in send],
                      [n * w for n in recv], mesh, "model")
    return got[..., :w], got[..., w:]


def pair_plan(m: int, j: int) -> Tuple[bool, list, list]:
    """``_pair_channels``' exchange on rank j of m: (whether its two
    sub-blocks go out in the other order, sub-blocks sent to each rank,
    sub-blocks received from each rank).  Sub-block q (of 2m) belongs to
    rank q mod m; the pieces travel in destination order."""
    dest = [(2 * j + i) % m for i in (0, 1)]
    send, recv = [0] * m, [0] * m
    for d in dest:
        send[d] += 1
    for q in (j, m + j):
        recv[q // 2] += 1
    return dest[1] < dest[0], send, recv


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Partial sums over ``model`` summed, entering the channels again
    (``reduce_from`` then ``copy_to``)."""
    return tp.copy_to(tp.reduce_from(x, mesh, "model"), mesh, "model")


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


def _project(x: torch.Tensor, p: Dict[str, torch.Tensor],
             ctx: Optional[SSMMesh]):
    """(x as the channels take it, xi, z) of ``x @ w_in``: on a rank's
    ``d_inner`` block, x enters through ``copy_to`` and the flat block
    is moved to the rank's channels (``_pair_channels``)."""
    if ctx is None:
        return (x,) + tuple(torch.chunk(x @ p["w_in"], 2, dim=-1))
    x = tp.copy_to(x, ctx.mesh, "model")
    if ctx.layout == "paired":
        return (x,) + tuple(torch.chunk(x @ p["w_in"], 2, dim=-1))
    return (x,) + _pair_channels(x @ p["w_in"], ctx.mesh)


def _sum(x: torch.Tensor, ctx: Optional[SSMMesh]) -> torch.Tensor:
    return x if ctx is None else _psum(x, ctx.mesh)


def _leave(y: torch.Tensor, ctx: Optional[SSMMesh]) -> torch.Tensor:
    """``w_out``'s product leaving the layer (partial sums over ``model``
    summed on a rank's ``d_inner`` block)."""
    return y if ctx is None else tp.reduce_from(y, ctx.mesh, "model")


def _gate_norm(y: torch.Tensor, w: torch.Tensor, ctx: Optional[SSMMesh]):
    if ctx is None:
        return rms_norm(y, w)
    return tp_rms_norm(y, w, 1e-6, ctx.mesh)


def _dt1(xi: torch.Tensor, p, ctx: Optional[SSMMesh]) -> torch.Tensor:
    """Mamba1's dt [B, L, di] in f32: the low-rank projection in the
    compute dtype, then softplus, then the cast, as in JAX."""
    low = _sum(xi @ p["w_dt_down"], ctx)
    return F.softplus(low @ p["w_dt_up"] + p["dt_bias"].to(xi.dtype)
                      ).to(_F32)


def mamba_scan_inputs(x: torch.Tensor, p: Dict[str, torch.Tensor],
                      ctx: Optional[SSMMesh] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The selective scan's inputs as ``mamba_block`` makes them from
    x [B, L, D]: (dt, xi, b_in, c_out), contiguous f32, and the gate z in
    x's dtype (on a rank's ``d_inner`` block, its channels)."""
    dtype = x.dtype
    _x, xi, z = _project(x, p, ctx)
    xi = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xi = F.silu(xi.to(_F32)).to(dtype)
    bc = _sum(xi @ p["w_bc"], ctx)
    b_in, c_out = (t.contiguous() for t in torch.chunk(bc.to(_F32), 2,
                                                       dim=-1))
    dt = _dt1(xi, p, ctx)                                    # [B, L, di]
    return dt, xi.to(_F32).contiguous(), b_in, c_out, z


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
                s: SSMConfig, remat_chunks: bool = False,
                ctx: Optional[SSMMesh] = None) -> torch.Tensor:
    """Prefill and training forward. x [B, L, D] -> [B, L, D].  On a
    mesh, ``p`` is ``local_mamba``'s and ``ctx`` the rank's (see the
    module docstring)."""
    if ctx is not None and ctx.layout == "rows":
        return _rows_block(x, p, d_model, s, remat_chunks, ctx.mesh)
    dtype = x.dtype
    if s.version == 1:
        if s.use_scan_kernel:
            _no_scan_backward(x, p)
        dt, xi32, b_in, c_out, z = mamba_scan_inputs(x, p, ctx)
        if s.use_scan_kernel:
            y = kops.mamba_scan(dt, xi32, b_in, c_out, p["A_log"])
        else:
            a = -torch.exp(p["A_log"])                       # [di, N]
            y = _chunked_scan(dt, xi32, b_in, c_out, a, s.chunk,
                              remat_chunks)
        y = y + p["D"] * xi32
        y = y.to(dtype) * F.silu(z.to(_F32)).to(dtype)
        return _leave(y @ p["w_out"], ctx)
    b, l, _ = x.shape
    xw, xi, z = _project(x, p, ctx)
    di = xi.shape[-1]
    nh = di // s.head_dim
    xi = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xi = F.silu(xi.to(_F32)).to(dtype)
    bc = xw @ p["w_bc"]
    b_in, c_out = torch.chunk(bc.to(_F32), 2, dim=-1)         # [B, L, N]
    dt = F.softplus((xw @ p["w_dt"]).to(_F32) + p["dt_bias"])  # [B, L, H]
    a = -torch.exp(p["A_log"])                                # [H]
    xh = xi.reshape(b, l, nh, s.head_dim).to(_F32)
    y = _chunked_scan2(dt, xh, b_in, c_out, a, s.chunk, remat_chunks)
    y = y + p["D"][:, None] * xh
    y = y.reshape(b, l, di).to(dtype)
    y = _gate_norm(y * F.silu(z.to(_F32)).to(dtype), p["gate_norm"], ctx)
    return _leave(y @ p["w_out"], ctx)


def _rows_block(x: torch.Tensor, p: Dict[str, torch.Tensor], d_model: int,
               s: SSMConfig, remat_chunks: bool, mesh) -> torch.Tensor:
    """``batch_tp``'s layer: the rank's block of the rows over ``model``
    through the meshless block on whole weights, the rows gathered back
    (every rank runs every row where they do not split)."""
    if x.shape[0] % tp.axis_size(mesh, "model"):
        return mamba_block(x, p, d_model, s, remat_chunks)
    p = {k: tp.copy_to(v, mesh, "model") for k, v in p.items()}
    y = mamba_block(tp.scatter(x, mesh, "model", 0), p, d_model, s,
                    remat_chunks)
    return tp.gather(y, mesh, "model", 0, grad="slice")


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
                      s: SSMConfig, ctx: Optional[SSMMesh] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence. x [B, 1, D]; returns (y [B, 1, D], new
    state); the given state is not modified.  On a rank's ``d_inner``
    block (``ctx``), ``state`` and ``p`` hold its channels; under
    ``batch_tp`` (``"rows"``), ``p`` is whole and ``state`` the rank's
    channels (whole where ``d_inner`` does not split)."""
    if ctx is not None and ctx.layout == "rows":
        if state["conv"].shape[-1] == p["conv_b"].shape[0]:
            ctx = None
        else:
            p = _channels(p, s, ctx.mesh)
            ctx = SSMMesh(ctx.mesh, "paired")
    b = x.shape[0]
    dtype = x.dtype
    xw, xi, z = _project(x, p, ctx)                          # [B, 1, di]
    di = xi.shape[-1]
    conv_buf = torch.cat([state["conv"], xi], dim=1)         # [B, K, di]
    xi = (conv_buf * p["conv_w"][None]).sum(dim=1, keepdim=True) \
        + p["conv_b"]
    xi = F.silu(xi.to(_F32)).to(dtype)
    new_conv = conv_buf[:, 1:]
    if s.version == 1:
        bc = _sum(xi @ p["w_bc"], ctx)
        b_in, c_out = torch.chunk(bc.to(_F32), 2, dim=-1)
        dt = _dt1(xi, p, ctx)[:, 0]                          # [B, di]
        a = -torch.exp(p["A_log"])
        a_bar = torch.exp(dt[..., None] * a)                 # [B, di, N]
        xi0 = xi[:, 0].to(_F32)
        bx = (dt * xi0)[..., None] * b_in[:, 0, None, :]
        h = a_bar * state["h"] + bx
        y = torch.einsum("bdn,bn->bd", h, c_out[:, 0])
        y = y + p["D"] * xi0
        y = y[:, None].to(dtype) * F.silu(z.to(_F32)).to(dtype)
        return _leave(y @ p["w_out"], ctx), {"h": h, "conv": new_conv}
    nh = di // s.head_dim
    bc = xw @ p["w_bc"]
    b_in, c_out = torch.chunk(bc.to(_F32), 2, dim=-1)        # [B, 1, N]
    dt = F.softplus((xw @ p["w_dt"]).to(_F32) + p["dt_bias"])[:, 0]  # [B, H]
    a = -torch.exp(p["A_log"])
    a_bar = torch.exp(dt * a)                                # [B, H]
    xh = xi[:, 0].reshape(b, nh, s.head_dim).to(_F32)
    bx = (dt[..., None] * xh)[..., None] * b_in[:, 0, None, None, :]
    h = a_bar[..., None, None] * state["h"] + bx
    y = torch.einsum("bhdn,bn->bhd", h, c_out[:, 0])
    y = y + p["D"][:, None] * xh
    y = y.reshape(b, 1, di).to(dtype)
    y = _gate_norm(y * F.silu(z.to(_F32)).to(dtype), p["gate_norm"], ctx)
    return _leave(y @ p["w_out"], ctx), {"h": h, "conv": new_conv}
