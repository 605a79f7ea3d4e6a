"""Shared neural-net layers (functional, explicit parameter dicts).

Port of ``repro.models.layers``: ``dtype_of``, ``Initializer``,
``rms_norm``, ``softcap``, ``rope``, ``init_dense``, ``init_mlp`` and the
MLP block (``swiglu``, alias ``gelu_mlp``).  ``rope`` is the half-split
convention computed in f32; the GELU is ``jax.nn.gelu``'s default, the
tanh approximation.  ``chunked_cross_entropy`` is the training loss: the
unembedding and the log-sum-exp run per sequence chunk, and each chunk's
[B, c, V] logits are recomputed in the backward pass (the JAX body's
``jax.checkpoint``), so no more than one chunk's logits is ever held.
``remat`` wraps a block in the JAX ``cfg.remat`` policy for training.

On a mesh: ``tp_swiglu`` is the MLP column parallel
(``w_up``/``w_gate`` over ``mlp``) then row parallel (``w_down``), its
partial sums summed over ``model``; ``xent_sums`` (the loss's sum and
count, without the division) takes the unembedding's ``vocab`` block of
a rank and then runs the log-sum-exp across ``model`` (a max and a sum
of exponentials over the ranks, the target's logit from the rank that
holds it), as JAX shards ``vocab`` over ``model``.  ``rms_norm`` and
``rope`` stay replicated; ``tp_rms_norm`` is the norm of a vector whose
last axis splits over ``model`` (Mamba2's ``gate_norm`` over a rank's
``d_inner`` block: the sum of squares summed over the ranks).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.dist import tensor_parallel as tp

__all__ = ["dtype_of", "Initializer", "rms_norm", "softcap", "rope",
           "init_dense", "init_mlp", "swiglu", "gelu_mlp",
           "chunked_cross_entropy", "xent_sums", "tp_swiglu",
           "tp_rms_norm", "remat",
           "checkpointed"]

_F32 = torch.float32
# a normal leaf past this many elements is drawn in slices along its first
# axis, so its f32 draw never holds more than this at once (arctic-480b's
# [128, 7168, 4864] expert leaves are 17.8 GB in f32)
_DRAW_SLICE = 1 << 28


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class Initializer:
    """Deterministic parameter init from one ``torch.Generator``.

    Draws on the generator's device, with the JAX package's stddevs and
    dtypes: a normal leaf is drawn in f32, scaled, then cast (a leaf of
    more than 2^28 elements slice by slice along its first axis).  The
    two libraries give different numbers from the same seed; the tests
    carry the JAX parameters across instead
    (``weights.model_params_from_numpy``).  ``device`` defaults to the
    generator's; ``"meta"`` takes a CPU generator (a meta tensor has no
    values, and meta has no generator of its own).
    """

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: Optional[torch.device] = None):
        self.generator = generator
        self.device = generator.device if device is None else device
        self.dtype = dtype

    def _draw(self, shape, stddev: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator, dtype=_F32,
                        device=self.device)
        return (x * stddev).to(self.dtype)

    def normal(self, shape: Sequence[int], stddev: float) -> torch.Tensor:
        shape = tuple(shape)
        n = 1
        for s in shape:
            n *= s
        if n <= _DRAW_SLICE or len(shape) < 2:
            return self._draw(shape, stddev)
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        rows = max(1, _DRAW_SLICE // (n // shape[0]))
        for i in range(0, shape[0], rows):
            part = out[i:i + rows]
            part.copy_(self._draw(tuple(part.shape), stddev))
        return out

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back to x's
    dtype."""
    x32 = x.to(_F32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + w.to(_F32))).to(x.dtype)


def tp_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, mesh
                ) -> torch.Tensor:
    """``rms_norm`` of the vector whose blocks over ``model`` the ranks
    hold (x [..., n/m], w its block of the weight): the mean square is
    the sum of the ranks' sums of squares over n (``rms_norm`` itself
    where ``model`` is 1)."""
    m = tp.axis_size(mesh, "model")
    if m == 1:
        return rms_norm(x, w, eps)
    x32 = x.to(_F32)
    ss = torch.sum(torch.square(x32), dim=-1, keepdim=True)
    ss = tp.copy_to(tp.reduce_from(ss, mesh, "model"), mesh, "model")
    var = ss / (x.shape[-1] * m)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + w.to(_F32))).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embeddings, half-split, in f32. x [..., L, H, Dh];
    positions [..., L]."""
    half = x.shape[-1] // 2
    freq = torch.pow(torch.tensor(theta, dtype=_F32, device=x.device),
                     -torch.arange(0, half, dtype=_F32, device=x.device)
                     / half)
    angle = positions[..., None].to(_F32) * freq             # [..., L, half]
    cos = torch.cos(angle)[..., None, :]
    sin = torch.sin(angle)[..., None, :]
    x1, x2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_dense(init: Initializer, d_in: int, d_out: int,
               stddev: Optional[float] = None) -> torch.Tensor:
    return init.normal((d_in, d_out), stddev or d_in ** -0.5)


def init_mlp(init: Initializer, d: int, f: int, act: str
             ) -> Dict[str, torch.Tensor]:
    p = {"w_up": init_dense(init, d, f),
         "w_down": init_dense(init, f, d, stddev=f ** -0.5)}
    if act == "swiglu":
        p["w_gate"] = init_dense(init, d, f)
    return p


def swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor],
           act: str = "swiglu") -> torch.Tensor:
    """MLP block: SwiGLU, or GELU (tanh approximation) when ``act`` is not
    ``"swiglu"``; the nonlinearity in f32, cast back to x's dtype."""
    up = x @ p["w_up"]
    if act == "swiglu":
        gate = x @ p["w_gate"]
        h = F.silu(gate.to(_F32)).to(x.dtype) * up
    else:
        h = F.gelu(up.to(_F32), approximate="tanh").to(x.dtype)
    return h @ p["w_down"]


gelu_mlp = swiglu  # same entry point; act selects the nonlinearity


def tp_swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor], act: str,
              split: bool, mesh) -> torch.Tensor:
    """``swiglu`` on a rank's ``mlp`` columns (``p`` gathered over
    ``fsdp``, ``mlp`` kept): x enters through ``copy_to`` and the
    row-parallel partial sums leave through ``reduce_from`` over
    ``model``.  Unsplit (``split`` False: ``model`` 1, or ``d_ff`` not
    dividing), ``swiglu`` itself on the whole weights."""
    if not split:
        return swiglu(x, p, act)
    out = swiglu(tp.copy_to(x, mesh, "model"), p, act)
    return tp.reduce_from(out, mesh, "model")


# ================================================================ training
def _requires_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    return False


def checkpointed(fn: Callable, *args, **kwargs):
    """``fn(*args)``, its activations recomputed in the backward pass when
    autograd records it: grad mode on and some tensor among ``args``
    (dicts and sequences walked) requiring grad.  Plain ``fn(*args)``
    otherwise, as when serving, whose weights require no grad."""
    if not (torch.is_grad_enabled() and _requires_grad(args)):
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)


# the matrix products without batch dimensions: the port's ``x @ W``
# (3-D times 2-D goes through ``mm``); the attention einsums are ``bmm``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = _ckpt.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_save_dots)


def remat(fn: Callable, mode: str) -> Callable:
    """The JAX ``_remat`` of a block under ``cfg.remat``: ``"none"`` keeps
    every activation; ``"full"`` recomputes the block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` saves the
    matrix products and recomputes the rest, as
    ``checkpoint_dots_with_no_batch_dims``.  Where autograd does not
    record (``checkpointed``: serving), every mode is ``fn`` itself."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")
    kwargs = {"context_fn": _dots_context} if mode == "dots" else {}

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpointed(fn, *args, **kwargs)

    return wrapped


def _xent_chunk(xc, unembed, tc, mc, logit_scale: float,
                cap: Optional[float]):
    logits = (xc * logit_scale) @ unembed.T                   # [B, c, V]
    logits = softcap(logits.to(_F32), cap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None])[..., 0]
    nll = (lse - gold) * mc
    return nll.sum(), mc.sum()


def _xent_chunk_tp(xc, unembed, tc, mc, logit_scale: float,
                   cap: Optional[float], mesh, lo: int):
    """``_xent_chunk`` with the logits' ``vocab`` over ``model``: this
    rank's logits are those of the rows ``[lo, lo + V_local)``."""
    logits = (xc * logit_scale) @ unembed.T                   # [B, c, Vl]
    logits = softcap(logits.to(_F32), cap)
    m = tp.all_reduce(logits.detach().amax(dim=-1), mesh, "model",
                      torch.distributed.ReduceOp.MAX)
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    lse = m + torch.log(tp.reduce_from(se, mesh, "model"))
    t = tc - lo
    own = (t >= 0) & (t < logits.shape[-1])
    gold = torch.gather(logits, -1, t.clamp(0, logits.shape[-1] - 1)
                        [..., None])[..., 0]
    gold = tp.reduce_from(torch.where(own, gold, 0.0), mesh, "model")
    nll = (lse - gold) * mc
    return nll.sum(), mc.sum()


def xent_sums(x: torch.Tensor, unembed: torch.Tensor,
              targets: torch.Tensor, chunk: int,
              logit_softcap: Optional[float] = None,
              mask: Optional[torch.Tensor] = None, logit_scale: float = 1.0,
              mesh=None, vocab_split: bool = False):
    """(sum of the masked nll, sum of the mask), f32 scalars, of
    ``chunked_cross_entropy``.  With ``vocab_split`` the rows of
    ``unembed`` are this rank's ``vocab`` block over ``model`` of
    ``mesh``, x enters through ``copy_to`` and each chunk's log-sum-exp
    runs across the ranks (``_xent_chunk_tp``)."""
    b, l, _d = x.shape
    n_chunks = max(l // chunk, 1)
    c = l // n_chunks
    if n_chunks * c != l:
        raise ValueError(f"chunked_cross_entropy: L={l} is not {n_chunks} "
                         f"chunks of {c} (as in the JAX package)")
    targets = targets.long()
    if mask is None:
        mask = torch.ones((b, l), dtype=_F32, device=x.device)
    mask = mask.to(_F32)
    if vocab_split:
        x = tp.copy_to(x, mesh, "model")
        lo = tp.axis_index(mesh, "model") * unembed.shape[0]
        fn = functools.partial(_xent_chunk_tp, mesh=mesh, lo=lo)
    else:
        fn = _xent_chunk
    total = torch.zeros((), dtype=_F32, device=x.device)
    count = torch.zeros((), dtype=_F32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        nll, n = checkpointed(fn, x[:, sl], unembed, targets[:, sl],
                              mask[:, sl], logit_scale, logit_softcap)
        total = total + nll
        count = count + n
    return total, count


def chunked_cross_entropy(x: torch.Tensor, unembed: torch.Tensor,
                          targets: torch.Tensor, chunk: int,
                          logit_softcap: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None,
                          logit_scale: float = 1.0) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy -> mean nll (f32 scalar).

    x [B, L, D] final hidden states, unembed [V, D], targets [B, L].
    ``max(L // chunk, 1)`` chunks of ``L // n_chunks`` positions (L must
    split evenly, as the JAX reshape needs); per chunk the logits
    ``(x * logit_scale) @ unembed.T`` in x's dtype, widened to f32,
    soft-capped, then log-sum-exp minus the target's logit, times
    ``mask`` (all ones when None).  The sums carry across chunks in f32
    in chunk order and the mean divides by ``max(sum(mask), 1)``."""
    total, count = xent_sums(x, unembed, targets, chunk, logit_softcap,
                             mask, logit_scale)
    return total / torch.clamp(count, min=1.0)
