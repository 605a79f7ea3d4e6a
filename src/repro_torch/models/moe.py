"""Mixture-of-Experts: top-k token-choice routing, global-capacity dispatch.

Port of ``repro.models.moe``.  Per token chunk: the router's softmax in
f32, top-k experts with their weights renormalised; each (token, choice)
pair ranked within its expert by a stable sort of the expert ids
(``jnp.argsort`` is stable) and the left-sided ``searchsorted`` of each
expert's first slot; pairs ranked past ``cap = min(max(int(tc * k / E *
capacity_factor), 4), tc * k)`` go to the overflow slot ``cap`` and are
dropped (weight 0).  The dispatch buffer [E, cap + 1, D] is a scatter-add
of the duplicated tokens, the experts run as batched products, and the
combine gathers each pair's row and sums over k.  The Switch
load-balancing and router z losses are returned as JAX returns them
(``aux`` f32, averaged over token chunks).  arctic's dense residual
branch lives in the transformer block.  ``moe_specs`` is the JAX
table of logical axes (``experts`` over ``model``, ``fsdp`` over
``data``).

**On a mesh** (``ctx``, a ``MoEMesh``): a rank holds its batch rows
(contiguous over the batch axes, replicated over ``model``) and, where
``experts`` splits, its ``E/m`` experts' weights (``fsdp`` gathered).
The routing keeps the reference's global semantics exactly: a chunk is
``token_chunk // B`` positions of the *global* batch, ``cap`` counts the
global chunk's pairs, and a pair's slot is the count of its expert's
pairs on the earlier data ranks (an exclusive prefix of the ``[E]``
counts gathered over the batch axes, into zero-filled buffers) plus its
rank among the rank's own
pairs, so ``slot`` and ``keep`` equal the meshless route's.  The
load-balancing and z terms are the rank's part of the global means
(its ``probs`` sum and ``lse^2`` sum over the global token count,
against the global expert counts), so summed over the batch axes they
are the reference's ``aux``, as ``train_loss`` sums the nll.  Every
``model`` rank routes the same tokens; each then runs only its experts,
on a buffer of ``min(cap, tk)`` rows an expert (a rank's kept pairs of
an expert never number more), and the partial outputs are summed over
``model`` (``reduce_from``): the tokens are already on every rank, so
no all-to-all is needed, and the one move is that all-reduce of
``[tokens, D]``.  The dispatch enters through ``copy_to`` and the
routing weights ``top_w`` too (each rank's gradient of them covers its
own experts' pairs), so every gradient is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models.layers import Initializer

__all__ = ["init_moe", "moe_specs", "moe_block", "route", "MoEMesh"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEMesh:
    """Where an MoE block runs: ``mesh``, whether the experts split over
    ``model`` (``split``), and the mesh's batch axes of size > 1 with
    their product ``dp`` and this rank's row-major index over them."""
    mesh: Any
    split: bool
    batch_axes: Tuple[str, ...]
    dp: int
    dp_index: int


def _dp_index(mesh, axes) -> int:
    i = 0
    for a in axes:
        i = i * tp.axis_size(mesh, a) + tp.axis_index(mesh, a)
    return i


def moe_mesh(mesh, split: bool, batch_axes: Tuple[str, ...]) -> MoEMesh:
    dp = 1
    for a in batch_axes:
        dp *= tp.axis_size(mesh, a)
    return MoEMesh(mesh, split, tuple(batch_axes), dp,
                   _dp_index(mesh, batch_axes))


def init_moe(init: Initializer, d_model: int, m: MoEConfig
             ) -> Dict[str, torch.Tensor]:
    e, f = m.n_experts, m.d_ff_expert
    return {
        "router": init.normal((d_model, e), d_model ** -0.5).to(_F32),
        "we_gate": init.normal((e, d_model, f), d_model ** -0.5),
        "we_up": init.normal((e, d_model, f), d_model ** -0.5),
        "we_down": init.normal((e, f, d_model), f ** -0.5),
    }


def moe_specs(m: MoEConfig):
    """Logical axes of ``init_moe``'s leaves (JAX ``moe_specs``)."""
    return {
        "router": (None, None),
        "we_gate": ("experts", "fsdp", None),
        "we_up": ("experts", "fsdp", None),
        "we_down": ("experts", None, "fsdp"),
    }


def _route(xc: torch.Tensor, p, m: MoEConfig, ctx: Optional[MoEMesh]):
    """``route`` and each pair's count of its expert's pairs on the
    earlier data ranks (``prefix`` [tc * k], 0 without a mesh)."""
    tc = xc.shape[0]
    k, e = m.top_k, m.n_experts
    tk = tc * k
    dp = 1 if ctx is None else ctx.dp
    gates = xc.to(_F32) @ p["router"]                        # [tc, E]
    probs = torch.softmax(gates, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)              # [tc, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    e_flat = top_e.reshape(tk)

    counts = torch.zeros((e,), dtype=_F32, device=xc.device).index_add_(
        0, e_flat, torch.ones(tk, dtype=_F32, device=xc.device))
    lse2 = torch.logsumexp(gates, dim=-1) ** 2
    if dp == 1:
        me, ce, z = probs.mean(dim=0), counts / tk, torch.mean(lse2)
        prefix = None
    else:
        # the rank's part of the global means, against the global counts
        # (whole numbers, exact in f32 below 2^24 pairs a chunk)
        # zero-filled: the counts index the buffer (a fake group may
        # leave a receive buffer as it was)
        every = tp.all_gather(counts[None], ctx.mesh, ctx.batch_axes, 0,
                              zeros=True)
        me = probs.sum(dim=0) / (tc * dp)
        ce = every.sum(dim=0) / (tk * dp)
        z = lse2.sum() / (tc * dp)
        prefix = every[:ctx.dp_index].sum(dim=0).long()[e_flat]
    aux = m.aux_loss * e * torch.sum(me * ce) + m.router_z_loss * z

    cap = min(max(int(tc * dp * k / e * m.capacity_factor), 4), tk * dp)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=xc.device))
    rank_sorted = (torch.arange(tk, device=xc.device) - start[sorted_e])
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    if prefix is not None:
        rank = rank + prefix
    keep = rank < cap
    slot = torch.where(keep, rank, cap)
    return top_w, top_e, slot, keep, cap, aux, prefix


def route(xc: torch.Tensor, p, m: MoEConfig, ctx: Optional[MoEMesh] = None):
    """Routing of one token chunk xc [tc, D]: ``(top_w [tc, k], top_e
    [tc, k], slot [tc * k], keep [tc * k], cap, aux)``; ``slot`` is each
    pair's rank within its expert, or ``cap`` (the overflow slot) where
    ``keep`` is False.  On a mesh (``ctx``), ``xc`` is the rank's
    tokens of the global chunk and ``slot``, ``keep`` and ``cap`` are
    the global chunk's (see the module docstring)."""
    return _route(xc, p, m, ctx)[:6]


def _process(xc: torch.Tensor, p, m: MoEConfig, ctx: Optional[MoEMesh]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, expert FFN and combine for one chunk [tc, D]:
    the experts of ``p`` (a rank's block of them where ``ctx.split``),
    each on ``min(cap, tc * k)`` rows and an overflow row."""
    tc, d = xc.shape
    k = m.top_k
    tk = tc * k
    top_w, top_e, slot, keep, cap, aux, prefix = _route(xc, p, m, ctx)
    e_flat = top_e.reshape(tk)
    el = p["we_gate"].shape[0]
    cap_l = min(cap, tk)
    split = ctx is not None and ctx.split
    if prefix is not None:
        # a rank's kept pairs of an expert lie at its slots past the
        # earlier ranks' count: row ``slot - prefix`` of its buffer
        slot = torch.where(keep, slot - prefix, cap_l)
    row = e_flat * (cap_l + 1) + slot
    if split:
        # the rank's experts; every other pair to expert 0's overflow row
        e_loc = e_flat - tp.axis_index(ctx.mesh, "model") * el
        mine = (e_loc >= 0) & (e_loc < el)
        row = torch.where(mine, e_loc * (cap_l + 1) + slot, cap_l)
        xc = tp.copy_to(xc, ctx.mesh, "model")
        top_w = tp.copy_to(top_w, ctx.mesh, "model")
    updates = xc[:, None, :].expand(tc, k, d).reshape(tk, d)
    buf = torch.zeros((el * (cap_l + 1), d), dtype=xc.dtype,
                      device=xc.device)
    buf.index_add_(0, row, updates)
    buf = buf.view(el, cap_l + 1, d)[:, :cap_l]

    gate = torch.bmm(buf, p["we_gate"])
    up = torch.bmm(buf, p["we_up"])
    h = F.silu(gate.to(_F32)).to(xc.dtype) * up
    out_e = torch.bmm(h, p["we_down"])                      # [E, cap, D]

    out_e = torch.cat([out_e, torch.zeros((el, 1, d), dtype=xc.dtype,
                                          device=xc.device)], dim=1)
    y_flat = out_e.reshape(el * (cap_l + 1), d)[row]        # [tk, D]
    w = (top_w.reshape(tk) * keep).to(xc.dtype)
    y = (y_flat * w[:, None]).reshape(tc, k, d).sum(dim=1)
    if split:
        y = tp.reduce_from(y, ctx.mesh, "model")
    return y, aux


def moe_block(x: torch.Tensor, p, m: MoEConfig,
              ctx: Optional[MoEMesh] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (output [B, S, D], aux loss f32).  Sequence chunks
    of ``max(token_chunk // B, 1)`` positions when S splits evenly into
    more than one, as in JAX; otherwise one chunk of all B * S tokens.
    On a mesh (``ctx``) ``x`` is the rank's rows, ``B`` above the global
    batch, and ``aux`` the rank's part (see the module docstring)."""
    b, s, d = x.shape
    s_chunk = max(m.token_chunk // (b * (1 if ctx is None else ctx.dp)), 1)
    n_chunks = s // s_chunk if (s % s_chunk == 0 and s > s_chunk) else 1
    if n_chunks == 1:
        y, aux = _process(x.reshape(b * s, d), p, m, ctx)
        return y.reshape(b, s, d), aux
    ys = []
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for i in range(n_chunks):
        xc = x[:, i * s_chunk:(i + 1) * s_chunk]
        yc, aux_c = _process(xc.reshape(b * s_chunk, d), p, m, ctx)
        aux = aux + aux_c / n_chunks
        ys.append(yc.reshape(b, s_chunk, d))
    return torch.cat(ys, dim=1), aux
