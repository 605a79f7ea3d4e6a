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
``data``); the mesh runs the dense family only, so the JAX module's
sharding hints inside ``moe_block`` have no counterpart yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Initializer

__all__ = ["init_moe", "moe_specs", "moe_block", "route"]

_F32 = torch.float32


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


def route(xc: torch.Tensor, p, m: MoEConfig):
    """Routing of one token chunk xc [tc, D]: ``(top_w [tc, k], top_e
    [tc, k], slot [tc * k], keep [tc * k], cap, aux)``; ``slot`` is each
    pair's rank within its expert, or ``cap`` (the overflow slot) where
    ``keep`` is False."""
    tc = xc.shape[0]
    k, e = m.top_k, m.n_experts
    tk = tc * k
    gates = xc.to(_F32) @ p["router"]                        # [tc, E]
    probs = torch.softmax(gates, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)              # [tc, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=0)
    ce = torch.zeros((e,), dtype=_F32, device=xc.device).index_add_(
        0, top_e.reshape(-1), torch.ones(tk, dtype=_F32, device=xc.device)
    ) / tk
    aux = m.aux_loss * e * torch.sum(me * ce)
    aux = aux + m.router_z_loss * torch.mean(
        torch.logsumexp(gates, dim=-1) ** 2)

    cap = min(max(int(tc * k / e * m.capacity_factor), 4), tk)
    e_flat = top_e.reshape(tk)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=xc.device))
    rank_sorted = (torch.arange(tk, device=xc.device) - start[sorted_e])
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < cap
    slot = torch.where(keep, rank, cap)
    return top_w, top_e, slot, keep, cap, aux


def _process(xc: torch.Tensor, p, m: MoEConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, expert FFN and combine for one chunk [tc, D]."""
    tc, d = xc.shape
    k, e = m.top_k, m.n_experts
    tk = tc * k
    top_w, top_e, slot, keep, cap, aux = route(xc, p, m)
    e_flat = top_e.reshape(tk)
    updates = xc[:, None, :].expand(tc, k, d).reshape(tk, d)
    buf = torch.zeros((e * (cap + 1), d), dtype=xc.dtype, device=xc.device)
    buf.index_add_(0, e_flat * (cap + 1) + slot, updates)
    buf = buf.view(e, cap + 1, d)[:, :cap]

    gate = torch.bmm(buf, p["we_gate"])
    up = torch.bmm(buf, p["we_up"])
    h = F.silu(gate.to(_F32)).to(xc.dtype) * up
    out_e = torch.bmm(h, p["we_down"])                      # [E, cap, D]

    out_e = torch.cat([out_e, torch.zeros((e, 1, d), dtype=xc.dtype,
                                          device=xc.device)], dim=1)
    y_flat = out_e[e_flat, slot]                            # [tk, D]
    w = (top_w.reshape(tk) * keep).to(xc.dtype)
    y = (y_flat * w[:, None]).reshape(tc, k, d).sum(dim=1)
    return y, aux


def moe_block(x: torch.Tensor, p, m: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (output [B, S, D], aux loss f32).  Sequence chunks
    of ``max(token_chunk // B, 1)`` positions when S splits evenly into
    more than one, as in JAX; otherwise one chunk of all B * S tokens."""
    b, s, d = x.shape
    s_chunk = max(m.token_chunk // b, 1)
    n_chunks = s // s_chunk if (s % s_chunk == 0 and s > s_chunk) else 1
    if n_chunks == 1:
        y, aux = _process(x.reshape(b * s, d), p, m)
        return y.reshape(b, s, d), aux
    ys = []
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for i in range(n_chunks):
        xc = x[:, i * s_chunk:(i + 1) * s_chunk]
        yc, aux_c = _process(xc.reshape(b * s_chunk, d), p, m)
        aux = aux + aux_c / n_chunks
        ys.append(yc.reshape(b, s_chunk, d))
    return torch.cat(ys, dim=1), aux
