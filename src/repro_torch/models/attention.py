"""Attention: GQA + RoPE + qk-norm + soft-capping + sliding window.

Port of ``repro.models.attention``.  ``flash_attention`` is the JAX
double-chunked online softmax (``attn_chunk_q`` x ``attn_chunk_k``
blocks) in plain PyTorch, scores and sums in f32: the prefill path of
every family.  The JAX reshape needs L to split evenly into
``max(L // chunk, 1)`` chunks; here the last chunk may be shorter, which
changes nothing for the lengths JAX takes.  ``self_attention`` and
``cross_attention`` (no causal mask, no RoPE on the KV source) call it.

``decode_attention`` is one query token against a K/V cache, on one of
two routes fixed by the config alone (``decode_route``):

* **kernel**: no ``attn_softcap`` and no local window (``window`` None or
  ``BIG_WINDOW``).  q is built as the JAX step builds it (projection,
  qk-norm, RoPE at ``cache_len - 1``, scaled by ``Dh^-0.5`` in x's dtype),
  then one ``ops.flash_decode(q.float(), k_cache, v_cache, cache_len)``:
  the CUDA kernel on the card, its plain version on CPU tensors.  The f32
  output is cast to x's dtype and goes through ``wo``.
* **plain**: softcap or a local window (gemma2-9b).  The JAX einsum
  softmax in plain PyTorch; the kernel has neither, as the Pallas kernel
  has neither.

``project_new_kv`` gives the new token's K/V; ``write_new_kv`` writes it
into a cache in place (a position at or past the cache's length is
dropped, as JAX's scatter drops it).

On a mesh (every attention of ``transformer`` and ``encdec``),
``attention_specs`` places
the weights as JAX does: ``wq`` ``("fsdp", "heads")``, ``wk``/``wv``
``("fsdp", "kv_heads")``, ``wo`` ``("heads", "fsdp")``, so ``heads``
splits the flat ``n_heads * head_dim`` axis.  ``local_attention`` gives
the weights a rank computes with: the ``fsdp`` blocks gathered, and the
heads split over ``model`` only where ``kv_heads`` divides by it (then
every rank's columns are whole heads, its q heads exactly those of its
kv heads); elsewhere (qwen3-14b's 8 kv heads at ``model`` 16, where a
rank stores half a kv head) the ``model`` blocks are gathered too and
every rank computes every head.  ``tp_self_attention`` and
``tp_decode_attention`` run the meshless functions on those weights, a
rank's heads in and ``wo``'s row-parallel partial sums summed over
``model`` out; the decode attention's ``ops.flash_decode`` gets the
rank's local q and kv heads.  ``tp_cross_attention`` is the same for
``cross_attention`` (vlm's patches, encdec's encoder output, and the
encoder's bidirectional self-attention, its K/V source its own input):
the K/V source enters through ``copy_to`` too, and the rank's
``wk``/``wv`` columns give its kv heads.  ``fill_cross_kv`` writes a
cross cache (the rank's kv heads on a mesh), and ``tp_decode_attention``
without RoPE decodes over it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.layers import Initializer, rms_norm, rope, softcap

__all__ = ["init_attention", "attention_specs", "heads_split",
           "local_attention", "tp_self_attention", "tp_decode_attention",
           "tp_cross_attention", "fill_cross_kv", "self_attention", "cross_attention", "decode_attention",
           "decode_route", "flash_attention", "project_new_kv",
           "write_new_kv", "update_kv_cache", "BIG_WINDOW", "NEG_INF"]

NEG_INF = -1e30
BIG_WINDOW = 1 << 30   # a global layer's window (transformer._windows_for)
_F32 = torch.float32


def init_attention(init: Initializer, d_model: int, a: AttnConfig
                   ) -> Dict[str, torch.Tensor]:
    dh = a.head_dim
    p = {
        "wq": init.normal((d_model, a.n_heads * dh), d_model ** -0.5),
        "wk": init.normal((d_model, a.kv_heads * dh), d_model ** -0.5),
        "wv": init.normal((d_model, a.kv_heads * dh), d_model ** -0.5),
        "wo": init.normal((a.n_heads * dh, d_model),
                          (a.n_heads * dh) ** -0.5),
    }
    if a.qk_norm:
        p["q_norm"] = init.zeros((dh,))
        p["k_norm"] = init.zeros((dh,))
    return p


def attention_specs(a: AttnConfig):
    """Logical axes of ``init_attention``'s leaves (JAX
    ``attention_specs``)."""
    s = {
        "wq": ("fsdp", "heads"),
        "wk": ("fsdp", "kv_heads"),
        "wv": ("fsdp", "kv_heads"),
        "wo": ("heads", "fsdp"),
    }
    if a.qk_norm:
        s["q_norm"] = (None,)
        s["k_norm"] = (None,)
    return s


def heads_split(a: AttnConfig, mesh) -> bool:
    """Whether a rank computes only its own heads: ``model`` > 1 and
    ``kv_heads`` divides by it."""
    m = tp.axis_size(mesh, "model")
    return m > 1 and a.kv_heads % m == 0


def local_attention(p, shardings, a: AttnConfig, mesh):
    """(weights, config, split) a rank computes its attention with, from
    its local shards ``p`` placed by ``shardings`` (``NamedSharding`` per
    leaf): the ``fsdp`` blocks gathered (their gradients summed back over
    the data axes), the ``model`` blocks kept where the heads split
    (``heads_split``; the config then counts the rank's heads, and the
    replicated ``q_norm``/``k_norm`` enter through ``copy_to``, so their
    gradients sum over the ranks' heads) and gathered otherwise (every
    rank then computes every head and keeps its block of each
    gradient)."""
    split = heads_split(a, mesh)
    keep = ("model",) if split else ()
    w = {}
    for k, x in p.items():
        x = tp.materialize(x, shardings[k].spec, mesh, keep)
        if split and k in ("q_norm", "k_norm"):
            x = tp.copy_to(x, mesh, "model")
        w[k] = x
    if split:
        m = tp.axis_size(mesh, "model")
        a = dataclasses.replace(a, n_heads=a.n_heads // m,
                                kv_heads=a.kv_heads // m)
    return w, a, split


def tp_self_attention(x, w, a: AttnConfig, split: bool, mesh,
                      positions, window=None, chunk_q: int = 512,
                      chunk_k: int = 1024) -> torch.Tensor:
    """``self_attention`` on ``local_attention``'s weights: x enters the
    rank's heads through ``copy_to`` and ``wo``'s partial sums leave
    through ``reduce_from`` over ``model`` (both the identity unless the
    heads split)."""
    if not split:
        return self_attention(x, w, a, positions, window, chunk_q, chunk_k)
    out = self_attention(tp.copy_to(x, mesh, "model"), w, a, positions,
                         window, chunk_q, chunk_k)
    return tp.reduce_from(out, mesh, "model")


def tp_cross_attention(x, x_kv, w, a: AttnConfig, split: bool, mesh,
                       chunk_q: int = 512, chunk_k: int = 1024
                       ) -> torch.Tensor:
    """``cross_attention`` on ``local_attention``'s weights: x and the
    K/V source x_kv (once, where it is x) enter the rank's heads through
    ``copy_to``, ``wo``'s partial sums leave through ``reduce_from``
    over ``model`` (all the identity unless the heads split)."""
    if not split:
        return cross_attention(x, x_kv, w, a, chunk_q, chunk_k)
    xq = tp.copy_to(x, mesh, "model")
    xk = xq if x_kv is x else tp.copy_to(x_kv, mesh, "model")
    out = cross_attention(xq, xk, w, a, chunk_q, chunk_k)
    return tp.reduce_from(out, mesh, "model")


def tp_decode_attention(x, w, a: AttnConfig, split: bool, mesh, k_cache,
                        v_cache, cache_len, window=None,
                        use_rope: bool = True) -> torch.Tensor:
    """``decode_attention`` of the rank's heads against its cache shard
    (``kv_heads`` over ``model`` where the heads split; a cross cache
    without RoPE), ``wo``'s partial sums summed over ``model``."""
    out = decode_attention(x, w, a, k_cache, v_cache, cache_len, window,
                           use_rope=use_rope)
    return tp.reduce_from(out, mesh, "model") if split else out


def fill_cross_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
                  x_kv: torch.Tensor, p, a: AttnConfig) -> None:
    """Write the K/V of x_kv [B, S, D] through ``p``'s ``wk``/``wv``
    (no ``k_norm``, no RoPE, as the reference) into k/v_cache [B, S,
    KH, Dh] in place, in the caches' dtype; the product in the promoted
    dtype of x_kv and the weight, as jnp's matmul promotes (vlm's f32
    patches against bf16 weights)."""
    b = x_kv.shape[0]
    for cache, name in ((k_cache, "wk"), (v_cache, "wv")):
        wt = p[name]
        dt = torch.promote_types(x_kv.dtype, wt.dtype)
        kv = x_kv.to(dt) @ wt.to(dt)
        cache.copy_(kv.reshape(b, -1, a.kv_heads, a.head_dim)
                    .to(cache.dtype))


def _project_qkv(x, x_kv, p, a: AttnConfig, positions, kv_positions,
                 use_rope: bool):
    b, lq, _ = x.shape
    dh = a.head_dim
    q = (x @ p["wq"]).reshape(b, lq, a.n_heads, dh)
    k = (x_kv @ p["wk"]).reshape(b, x_kv.shape[1], a.kv_heads, dh)
    v = (x_kv @ p["wv"]).reshape(b, x_kv.shape[1], a.kv_heads, dh)
    if a.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        q = rope(q, positions, a.rope_theta)
        k = rope(k, kv_positions, a.rope_theta)
    return q, k, v


def _chunks(n: int, chunk: int):
    """The JAX chunking of n positions, ``max(n // chunk, 1)`` chunks;
    the last one shorter where n does not split evenly."""
    nc = max(n // chunk, 1)
    c = -(-n // nc)
    return [(i, min(i + c, n)) for i in range(0, n, c)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window: Optional[int], cap: Optional[float],
                    chunk_q: int = 512, chunk_k: int = 1024) -> torch.Tensor:
    """q [B, Lq, H, Dh], k/v [B, Lk, KH, Dh], positions [Lq] / [Lk] ->
    [B, Lq, H, Dh] in q's dtype.  Per q chunk, an online softmax over the
    k chunks in f32 (the ``NEG_INF`` mask, alpha 0 while m is still
    ``NEG_INF``, masked p 0), then ``acc / max(l, 1e-20)``."""
    b, lq, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    qs = (q * dh ** -0.5).reshape(b, lq, kh, g, dh)
    outs = []
    for q0, q1 in _chunks(lq, chunk_q):
        qc = qs[:, q0:q1].to(_F32)                       # [B, cq, KH, G, Dh]
        qpc = q_pos[q0:q1]
        cq = q1 - q0
        m = torch.full((b, kh, g, cq), NEG_INF, dtype=_F32, device=q.device)
        l = torch.zeros((b, kh, g, cq), dtype=_F32, device=q.device)
        acc = torch.zeros((b, kh, g, cq, dh), dtype=_F32, device=q.device)
        for k0, k1 in _chunks(k.shape[1], chunk_k):
            kc = k[:, k0:k1].to(_F32)
            vc = v[:, k0:k1].to(_F32)
            kpc = k_pos[k0:k1]
            s = torch.einsum("bqkgd,bckd->bkgqc", qc, kc)
            s = softcap(s, cap)
            mask = torch.ones((cq, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= qpc[:, None] >= kpc[None, :]
            if window is not None:
                mask &= (qpc[:, None] - kpc[None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
            pexp = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", pexp, vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.to(q.dtype).permute(0, 3, 1, 2, 4)
                    .reshape(b, cq, h, dh))
    return torch.cat(outs, dim=1)


def self_attention(x: torch.Tensor, p, a: AttnConfig,
                   positions: torch.Tensor, window: Optional[int] = None,
                   chunk_q: int = 512, chunk_k: int = 1024) -> torch.Tensor:
    b, l, _ = x.shape
    q, k, v = _project_qkv(x, x, p, a, positions, positions, use_rope=True)
    out = flash_attention(q, k, v, positions, positions, causal=True,
                          window=window, cap=a.attn_softcap,
                          chunk_q=min(chunk_q, l), chunk_k=min(chunk_k, l))
    return out.reshape(b, l, a.n_heads * a.head_dim) @ p["wo"]


def cross_attention(x: torch.Tensor, x_kv: torch.Tensor, p, a: AttnConfig,
                    chunk_q: int = 512, chunk_k: int = 1024) -> torch.Tensor:
    """x [B, Lq, D] queries (text), x_kv [B, Lkv, D] keys/values (frames,
    patches)."""
    b, lq, _ = x.shape
    lkv = x_kv.shape[1]
    pos_q = torch.arange(lq, dtype=torch.int32, device=x.device)
    pos_k = torch.arange(lkv, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(x, x_kv, p, a, pos_q, pos_k, use_rope=False)
    out = flash_attention(q, k, v, pos_q, pos_k, causal=False, window=None,
                          cap=a.attn_softcap, chunk_q=min(chunk_q, lq),
                          chunk_k=min(chunk_k, lkv))
    return out.reshape(b, lq, a.n_heads * a.head_dim) @ p["wo"]


def decode_route(a: AttnConfig, window: Optional[int] = None) -> str:
    """``"kernel"`` (``ops.flash_decode``) where the layer has no softcap
    and no local window, else ``"plain"`` (the einsum softmax)."""
    local = window is not None and window < BIG_WINDOW
    return "plain" if a.attn_softcap is not None or local else "kernel"


def decode_attention(x: torch.Tensor, p, a: AttnConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, window: Optional[int] = None,
                     use_rope: bool = True,
                     route: Optional[str] = None) -> torch.Tensor:
    """One-token attention of x [B, 1, D] against k/v_cache [B, S, KH,
    Dh] (contiguous), ``cache_len`` i32[B] valid entries, the new token's
    K/V already written at ``cache_len - 1``.  ``route`` defaults to
    ``decode_route(a, window)``; the plain route may be asked for on any
    layer (the smoke holds the kernel route to it)."""
    b = x.shape[0]
    s, kh, dh = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    g = a.n_heads // kh
    positions = (cache_len - 1).to(torch.int32)                 # [B]
    q = (x @ p["wq"]).reshape(b, 1, a.n_heads, dh)
    if a.qk_norm:
        q = rms_norm(q, p["q_norm"])
    if use_rope:
        q = rope(q, positions[:, None], a.rope_theta)
    q = q.reshape(b, kh, g, dh) * (dh ** -0.5)
    route = route or decode_route(a, window)
    if route == "kernel":
        out = ops.flash_decode(q.reshape(b, a.n_heads, dh).to(_F32),
                               k_cache, v_cache, cache_len)
    else:
        scores = torch.einsum("bkgd,bskd->bkgs", q.to(_F32),
                              k_cache.to(_F32))
        scores = softcap(scores, a.attn_softcap)
        pos_k = torch.arange(s, dtype=torch.int32, device=x.device)[None]
        mask = pos_k < cache_len[:, None]
        if window is not None:
            mask &= (positions[:, None] - pos_k) < window
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.to(_F32))
    out = out.reshape(b, 1, a.n_heads * dh).to(x.dtype)
    return out @ p["wo"]


def project_new_kv(x: torch.Tensor, p, a: AttnConfig,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The new token's K/V [B, KH, Dh] (RoPE'd at ``positions`` [B], the
    entries before it)."""
    b = x.shape[0]
    dh = a.head_dim
    k = (x @ p["wk"]).reshape(b, a.kv_heads, dh)
    v = (x @ p["wv"]).reshape(b, a.kv_heads, dh)
    if a.qk_norm:
        k = rms_norm(k, p["k_norm"])
    k = rope(k[:, None], positions[:, None], a.rope_theta)[:, 0]
    return k, v


def write_new_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """``cache[b, positions[b]] = new[b]`` in place, in the caches' dtype,
    for caches [B, S, KH, Dh] and entries [B, KH, Dh]; a position at or
    past S is dropped (JAX's scatter drops it), with no host sync."""
    s = k_cache.shape[1]
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    pos = positions.to(torch.int64)
    keep = (pos < s)[:, None, None]
    at = torch.clamp(pos, max=s - 1)
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[bidx, at] = torch.where(keep, new.to(cache.dtype),
                                      cache[bidx, at])


def update_kv_cache(x: torch.Tensor, p, a: AttnConfig,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the new token's K/V and write it at each sequence's
    ``cache_len`` (entries before this token), in place; returns the
    caches."""
    k, v = project_new_kv(x, p, a, cache_len)
    write_new_kv(k_cache, v_cache, k, v, cache_len)
    return k_cache, v_cache
