"""Decoder-only assembly for the dense, moe, ssm, hybrid and vlm families:
init, forward, prefill, decode.

Port of ``repro.models.transformer``.  Parameters keep the JAX tree:
per-layer leaves stacked on a leading ``[n_layers, ...]`` axis, as
``_stack_init`` gives, plus ``shared_attn`` (hybrid: one attention block
applied after every ``hybrid_attn_every`` Mamba2 layers) and
``cross_layers`` (vlm: a tanh-gated cross-attention layer after every
``cross_attn_every`` dense layers, over ``extra["patches"]``).  The JAX
``lax.scan`` over layers is a Python loop over that axis; ``scan_layers``
and the sharding hints have no effect.  ``cfg.remat`` applies when
autograd records the forward (``train_loss``): each layer (and each vlm
cross layer and hybrid shared-attention application) is one
``layers.remat`` block, as the JAX ``_remat`` wraps the scan body;
serving, whose weights require no grad, runs without it.  gemma2's
local/global windows are per-layer ints (``_windows_for``), and with its
softcap they put every gemma2 layer's decode attention on the plain
route (``attention.decode_route``); every other family's decode
attention is one ``ops.flash_decode`` a layer (and one a cross layer).

``decode_step`` writes each attention layer's new K/V into the caches of
the state it is given, in place (the JAX step scatters into a donated
buffer): copying a [L, B, S, KH, Dh] cache each step would move as many
bytes as the attention reads.  The recurrent state (``ssm_h``,
``ssm_conv``) and ``cache_len`` are new tensors in the returned state.

Copied from the reference, not fixed: ``prefill`` runs ``forward`` on a
fresh decode state and returns it with ``cache_len`` set but every
self-attention K/V cache still zero (the reference's comment says the
prompt's K/V is "recomputed", but nothing writes it), so a decode step
after a prefill attends over zero K/V at the prompt's positions; the
ssm and hybrid prefills return ``ssm_h`` and ``ssm_conv`` zero (the
reference's scans drop the final state).  The vlm prefill does fill
``cross_k``/``cross_v`` from the patches (without ``k_norm``, as there).

**On a mesh** (a ``MeshPlan`` passed as ``plan``; ``models.model``
builds one for a model built with a ``mesh``): ``param_specs`` and
``decode_state_specs`` are the JAX tables of logical axes for every
family, and every family (encdec in ``models.encdec``, on the same
plan) runs ``forward``, ``train_loss``,
``prefill``, ``decode_step`` and ``logits_of`` on each rank's local
shards
(``param_sharding`` on each leaf's shape, ``guarded_spec``): rows over
the batch axes, weights over ``fsdp`` gathered for their use
(``tensor_parallel.materialize``), attention heads (where ``kv_heads``
divides), MLP columns and vocabulary over ``model``
(``attention.local_attention``, ``layers.tp_swiglu``,
``layers.xent_sums``), experts over ``model`` with the reference's
global capacity (``moe.moe_block``), and Mamba layers on a rank's
``d_inner`` block (``ssm.local_mamba``), or under ``batch_tp`` on its
block of the rows with ``d_inner`` whole (``ssm.SSMMesh``'s
``"rows"``).  zamba2's ``shared_attn`` is a dense block with its own
shardings.  vlm's cross layers (``cross_layers``, shardings
``plan.cross``) attend from the rank's heads to the patches
(``attention.tp_cross_attention``; the K/V through the rank's
``wk``/``wv`` columns); their tanh ``gate`` is replicated and enters no
collective, so its gradient is each rank's whole one, summed over the
batch axes alone; the prefill fills ``cross_k``/``cross_v`` with the
rank's kv heads (all of them where the heads do not split, as
llama-3.2-vision-11b's 8 at ``model`` 16), and a decode step reads the
rank's shard of them (``attention.tp_decode_attention`` without RoPE).  ``train_loss`` returns the rank's part of the
global mean (its nll sum over the global mask count, and its part of
the MoE ``aux``), which ``train.train_step`` sums over the batch axes;
``decode_step`` and ``prefill`` return the rank's rows' logits over the
whole vocabulary, and the decode state is the rank's shard (K/V caches
over the kv heads where they split, vlm's ``cross_k``/``cross_v``
likewise, ``ssm_h``/``ssm_conv`` over ``d_inner``).  The blocks are the
meshless ones: every tensor-parallel move is the identity without a
plan.  The JAX ``constrain`` sites (the embedding's output, the decode
step's, the logits) keep their names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import (NamedSharding, constrain,
                                       param_sharding)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Initializer, dtype_of, init_mlp,
                                       remat, rms_norm, softcap, swiglu,
                                       tp_swiglu, xent_sums)

__all__ = ["init_params", "param_specs", "forward", "train_loss",
           "init_decode_state", "decode_state_specs", "decode_step",
           "prefill", "logits_of", "layer_params", "mesh_plan",
           "state_sharding", "MeshPlan", "FAMILIES"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
BIG_WINDOW = attn.BIG_WINDOW
_F32 = torch.float32


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


# =========================================================== initialization
def _init_dense_layer(init: Initializer, cfg: ModelConfig):
    return {"ln1": init.zeros((cfg.d_model,)),
            "attn": attn.init_attention(init, cfg.d_model, cfg.attn),
            "ln2": init.zeros((cfg.d_model,)),
            "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, cfg.act)}


def _init_moe_layer(init: Initializer, cfg: ModelConfig):
    p = {"ln1": init.zeros((cfg.d_model,)),
         "attn": attn.init_attention(init, cfg.d_model, cfg.attn),
         "ln2": init.zeros((cfg.d_model,)),
         "moe": moe_mod.init_moe(init, cfg.d_model, cfg.moe)}
    if cfg.moe.dense_residual_d_ff:
        p["dense_mlp"] = init_mlp(init, cfg.d_model,
                                  cfg.moe.dense_residual_d_ff, cfg.act)
    return p


def _init_ssm_layer(init: Initializer, cfg: ModelConfig):
    return {"ln": init.zeros((cfg.d_model,)),
            "ssm": ssm_mod.init_mamba(init, cfg.d_model, cfg.ssm)}


def _init_cross_layer(init: Initializer, cfg: ModelConfig):
    return {"ln": init.zeros((cfg.d_model,)),
            "attn": attn.init_attention(init, cfg.d_model, cfg.attn),
            "gate": init.zeros(())}   # llama-3.2-vision gated cross-attn


def _stack_init(fn, init: Initializer, n: int, cfg: ModelConfig):
    """``n`` layers of ``fn`` stacked on a leading axis, drawn one layer
    at a time into preallocated leaves (no second copy of the stack; one
    layer is a view of itself)."""
    first = fn(init, cfg)
    if n == 1:
        return _map(lambda x: x.unsqueeze(0), first)
    out = _map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                     device=x.device), first)
    _zip(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, n):
        _zip(lambda o, x: o[i].copy_(x), out, fn(init, cfg))
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip(fn, a[k], b[k])
    else:
        fn(a, b)


def _slice(tree, i):
    return _map(lambda x: x[i], tree)


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters (views into the stacked leaves)."""
    return _slice(params["layers"], i)


_LAYER_INIT = {"dense": _init_dense_layer, "vlm": _init_dense_layer,
               "moe": _init_moe_layer, "ssm": _init_ssm_layer,
               "hybrid": _init_ssm_layer}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random parameters on ``device`` (default: the generator's), with
    the JAX tree's shapes and dtypes."""
    _check_family(cfg)
    init = Initializer(generator, dtype_of(cfg.param_dtype), device)
    params: Dict[str, Any] = {
        "embed": init.normal((cfg.vocab, cfg.d_model), 1.0),
        "final_norm": init.zeros((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init.normal((cfg.vocab, cfg.d_model),
                                        cfg.d_model ** -0.5)
    params["layers"] = _stack_init(_LAYER_INIT[cfg.family], init,
                                   cfg.n_layers, cfg)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_dense_layer(init, cfg)
    if cfg.family == "vlm":
        params["cross_layers"] = _stack_init(
            _init_cross_layer, init, cfg.n_layers // cfg.cross_attn_every,
            cfg)
    return params


# ============================================================ sharding specs
def _mlp_specs(cfg: ModelConfig, act: str):
    s = {"w_up": ("fsdp", "mlp"), "w_down": ("mlp", "fsdp")}
    if act == "swiglu":
        s["w_gate"] = ("fsdp", "mlp")
    return s


def _dense_layer_specs(cfg: ModelConfig):
    return {"ln1": (None,), "attn": attn.attention_specs(cfg.attn),
            "ln2": (None,), "mlp": _mlp_specs(cfg, cfg.act)}


def _moe_layer_specs(cfg: ModelConfig):
    s = {"ln1": (None,), "attn": attn.attention_specs(cfg.attn),
         "ln2": (None,), "moe": moe_mod.moe_specs(cfg.moe)}
    if cfg.moe.dense_residual_d_ff:
        s["dense_mlp"] = _mlp_specs(cfg, "swiglu")
    return s


def _ssm_layer_specs(cfg: ModelConfig):
    return {"ln": (None,), "ssm": ssm_mod.mamba_specs(cfg.d_model, cfg.ssm)}


def _cross_layer_specs(cfg: ModelConfig):
    return {"ln": (None,), "attn": attn.attention_specs(cfg.attn),
            "gate": ()}


def _stack_specs(specs):
    """Prepend the layer axis (None) to every leaf spec tuple."""
    if isinstance(specs, dict):
        return {k: _stack_specs(v) for k, v in specs.items()}
    return (None,) + specs


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of every parameter leaf (JAX ``param_specs``)."""
    _check_family(cfg)
    specs: Dict[str, Any] = {"embed": ("vocab", "fsdp"),
                             "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["unembed"] = ("vocab", "fsdp")
    fam = cfg.family
    if fam == "dense":
        specs["layers"] = _stack_specs(_dense_layer_specs(cfg))
    elif fam == "moe":
        specs["layers"] = _stack_specs(_moe_layer_specs(cfg))
    elif fam in ("ssm", "hybrid"):
        specs["layers"] = _stack_specs(_ssm_layer_specs(cfg))
        if fam == "hybrid":
            specs["shared_attn"] = _dense_layer_specs(cfg)
    else:  # vlm
        specs["layers"] = _stack_specs(_dense_layer_specs(cfg))
        specs["cross_layers"] = _stack_specs(_cross_layer_specs(cfg))
    return specs


def decode_state_specs(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of the decode state (JAX ``decode_state_specs``)."""
    _check_family(cfg)
    specs: Dict[str, Any] = {"cache_len": ("batch",)}
    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "hybrid"):
        specs["k_cache"] = (None, "batch", "kv_seq", "kv_heads", None)
        specs["v_cache"] = (None, "batch", "kv_seq", "kv_heads", None)
    if fam == "vlm":
        specs["cross_k"] = (None, "batch", None, "kv_heads", None)
        specs["cross_v"] = (None, "batch", None, "kv_heads", None)
    if fam in ("ssm", "hybrid"):
        if cfg.ssm.version == 1:
            specs["ssm_h"] = (None, "batch", "d_inner", None)
        else:
            specs["ssm_h"] = (None, "batch", "d_inner", None, None)
        specs["ssm_conv"] = (None, "batch", None, "d_inner")
    return specs


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How a model runs on ``mesh``: each parameter leaf's
    ``NamedSharding`` (``guarded_spec`` on its shape), a layer's (the
    layer axis dropped: ``layer`` a decoder layer's, ``cross`` a vlm
    cross layer's, ``enc`` an encdec encoder layer's), and which
    products split over ``model``: the attention heads (``kv_heads``
    divides), the MLP columns (``d_ff`` does: the dense MLP, arctic's
    dense residual or zamba2's shared block), the vocabulary (``vocab``
    does), the experts (``n_experts`` does), ``d_inner`` (``ssm``, where
    ``ssm.inner_splits``) or, under ``batch_tp``, the Mamba layers' rows
    (``rows``).  ``batch_axes`` are the mesh's data axes of size > 1,
    ``dp`` their product."""
    cfg: ModelConfig
    mesh: Any
    shardings: Dict[str, Any]
    layer: Dict[str, Any]
    heads: bool
    mlp: bool
    vocab: bool
    batch_axes: Tuple[str, ...]
    dp: int
    experts: bool = False
    ssm: bool = False
    rows: bool = False
    cross: Optional[Dict[str, Any]] = None
    enc: Optional[Dict[str, Any]] = None


def _drop_layer_axis(tree):
    if isinstance(tree, dict):
        return {k: _drop_layer_axis(v) for k, v in tree.items()}
    return NamedSharding(tree.mesh, tuple(tree.spec)[1:])


def _splits(sharding: NamedSharding, dim: int) -> bool:
    """Whether ``dim`` splits over a ``model`` axis of size > 1."""
    spec = tuple(sharding.spec)
    e = spec[dim] if dim < len(spec) else None
    return (tp.axis_size(sharding.mesh, "model") > 1
            and (e == "model" or (isinstance(e, tuple) and "model" in e)))


def _check_known_family(cfg: ModelConfig) -> None:
    """``_check_family`` with encdec (``models.encdec``) admitted."""
    if cfg.family not in FAMILIES + ("encdec",):
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


def _tables(cfg: ModelConfig):
    """(init_params, param_specs, decode_state_specs) of ``cfg``'s
    family (encdec's in ``models.encdec``)."""
    if cfg.family == "encdec":
        from repro_torch.models import encdec as ed
        return ed.init_params, ed.param_specs, ed.decode_state_specs
    return init_params, param_specs, decode_state_specs


def _batch_axes(mesh) -> Tuple[Tuple[str, ...], int]:
    """The mesh's data axes of size > 1 and the product of their
    sizes."""
    bat = tuple(a for a in tp.BATCH_AXES if tp.axis_size(mesh, a) > 1)
    dp = 1
    for a in bat:
        dp *= tp.axis_size(mesh, a)
    return bat, dp


def _mlp_block_shardings(cfg: ModelConfig, sh, lay):
    """The shardings of the dense MLP a family runs (None: none)."""
    if cfg.family == "hybrid":
        return sh["shared_attn"]["mlp"]
    return lay.get("mlp", lay.get("dense_mlp"))


def mesh_plan(cfg: ModelConfig, mesh) -> MeshPlan:
    """The ``MeshPlan`` of ``cfg`` on ``mesh`` (``models.model`` builds
    it once per model)."""
    _check_known_family(cfg)
    init, specs, _states = _tables(cfg)
    shapes = init(torch.Generator(), cfg, torch.device("meta"))
    sh = param_sharding(specs(cfg), mesh, shapes)
    lay = _drop_layer_axis(sh["dec_layers" if "dec_layers" in sh
                              else "layers"])
    bat, dp = _batch_axes(mesh)
    mlp = _mlp_block_shardings(cfg, sh, lay)
    s = cfg.ssm
    return MeshPlan(cfg=cfg, mesh=mesh, shardings=sh, layer=lay,
                    heads=(cfg.attn is not None
                           and attn.heads_split(cfg.attn, mesh)),
                    mlp=mlp is not None and _splits(mlp["w_up"], 1),
                    vocab=_splits(sh["embed"], 0), batch_axes=bat, dp=dp,
                    experts=("moe" in lay
                             and _splits(lay["moe"]["we_gate"], 0)),
                    ssm=(s is not None and not s.batch_tp
                         and ssm_mod.inner_splits(cfg.d_model, s, mesh)),
                    rows=(s is not None and s.batch_tp
                          and tp.axis_size(mesh, "model") > 1),
                    cross=(_drop_layer_axis(sh["cross_layers"])
                           if "cross_layers" in sh else None),
                    enc=(_drop_layer_axis(sh["enc_layers"])
                         if "enc_layers" in sh else None))


def _state_leaves(cfg: ModelConfig, batch: int, max_len: int):
    """{name: (shape, dtype)} of the whole decode state (no tensor is
    made: the dry run counts what is)."""
    dt = dtype_of(cfg.compute_dtype)
    fam = cfg.family
    a = cfg.attn
    out = {"cache_len": ((batch,), torch.int32)}
    if fam in ("dense", "moe", "vlm", "encdec"):
        kv = (cfg.n_layers, batch, max_len, a.kv_heads, a.head_dim)
        out["k_cache"] = out["v_cache"] = (kv, dt)
    if fam in ("vlm", "encdec"):
        cross = ((cfg.n_layers // cfg.cross_attn_every, batch,
                  cfg.n_patches) if fam == "vlm"
                 else (cfg.n_layers, batch, cfg.enc_seq))
        out["cross_k"] = out["cross_v"] = (cross + (a.kv_heads, a.head_dim),
                                           dt)
    if fam in ("ssm", "hybrid"):
        s = cfg.ssm
        di = s.expand * cfg.d_model
        h = ((batch, di, s.state_dim) if s.version == 1 else
             (batch, di // s.head_dim, s.head_dim, s.state_dim))
        out["ssm_h"] = ((cfg.n_layers,) + h, _F32)
        out["ssm_conv"] = ((cfg.n_layers, batch, s.conv_width - 1, di), dt)
    if fam == "hybrid":
        kv = (cfg.n_layers // cfg.hybrid_attn_every, batch, max_len,
              a.kv_heads, a.head_dim)
        out["k_cache"] = out["v_cache"] = (kv, dt)
    return out


def state_sharding(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The decode state's ``NamedSharding`` tree for ``batch`` rows over
    the whole mesh (``decode_state_specs``, guarded on each leaf's
    shape: rows that do not split over the batch axes are on every data
    rank, as long_500k's one row; an MoE model raises there)."""
    _check_known_family(cfg)
    s, m = cfg.ssm, tp.axis_size(mesh, "model")
    di = 0 if s is None else s.expand * cfg.d_model
    if s is not None and s.version == 2 and di % m == 0 \
            and (di // m) % s.head_dim:
        raise ValueError(
            f"{cfg.name}: a decode state on a model axis of {m} splits "
            f"ssm_conv's d_inner ({di}) but not ssm_h's heads: a rank's "
            f"d_inner block must be whole heads of {s.head_dim}")
    _bat, dp = _batch_axes(mesh)
    if batch % dp and cfg.family == "moe":
        # routing counts each data rank's rows as its own
        raise ValueError(f"a batch of {batch} does not split over the "
                         f"mesh's {dp} data-parallel ranks")
    shapes = {k: v[0] for k, v in _state_leaves(cfg, batch,
                                               max_len).items()}
    return param_sharding(_tables(cfg)[2](cfg), mesh, shapes)


# ============================================================ layer bodies
def _windows_for(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (gemma2 alternates local/global: even
    layers local, odd global)."""
    w = [BIG_WINDOW] * cfg.n_layers
    if cfg.attn is not None and cfg.attn.pattern == "local_global" \
            and cfg.attn.window:
        w[::2] = [cfg.attn.window] * len(w[::2])
    return w


def _self_attn(x, lp, cfg: ModelConfig, positions, window,
               plan: Optional[MeshPlan], sh):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    w, a, split = _attn_weights(lp, cfg, plan, sh)
    h = attn.tp_self_attention(h, w, a, split, _mesh(plan), positions,
                               window, cfg.attn_chunk_q, cfg.attn_chunk_k)
    return x + h


def _dense_block(x, lp, cfg: ModelConfig, positions, window,
                 plan: Optional[MeshPlan] = None, sh=None):
    """A dense block; ``sh`` its shardings on a mesh (default a
    stacked layer's, ``plan.layer``)."""
    x = _self_attn(x, lp, cfg, positions, window, plan, sh)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _mlp(h, lp["mlp"], cfg, plan, _sh(plan, sh, "mlp"))


def _moe_ffn(h, lp, cfg: ModelConfig, plan: Optional[MeshPlan] = None):
    if plan is None:
        y, aux = moe_mod.moe_block(h, lp["moe"], cfg.moe)
    else:
        w = {k: tp.materialize(v, plan.layer["moe"][k].spec, plan.mesh,
                               _keep(plan.experts))
             for k, v in lp["moe"].items()}
        ctx = (moe_mod.moe_mesh(plan.mesh, plan.experts, plan.batch_axes)
               if plan.experts or plan.dp > 1 else None)
        y, aux = moe_mod.moe_block(h, w, cfg.moe, ctx)
    if cfg.moe.dense_residual_d_ff:
        y = y + _mlp(h, lp["dense_mlp"], cfg, plan,
                     _sh(plan, None, "dense_mlp"))
    return y, aux


def _moe_block(x, lp, cfg: ModelConfig, positions, window,
               plan: Optional[MeshPlan] = None):
    x = _self_attn(x, lp, cfg, positions, window, plan, None)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = _moe_ffn(h, lp, cfg, plan)
    return x + y, aux


def _mamba(lp, cfg: ModelConfig, plan: Optional[MeshPlan]):
    """(weights, ``SSMMesh`` or None) a rank runs layer ``lp``'s Mamba
    block with."""
    if plan is None:
        return lp["ssm"], None
    w = ssm_mod.local_mamba(lp["ssm"], plan.layer["ssm"], cfg.ssm,
                            plan.mesh, plan.ssm)
    if plan.ssm:
        return w, ssm_mod.SSMMesh(plan.mesh)
    return w, ssm_mod.SSMMesh(plan.mesh, "rows") if plan.rows else None


def _ssm_block(x, lp, cfg: ModelConfig, plan: Optional[MeshPlan] = None):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    w, ctx = _mamba(lp, cfg, plan)
    return x + ssm_mod.mamba_block(h, w, cfg.d_model, cfg.ssm,
                                   remat_chunks=cfg.remat != "none",
                                   ctx=ctx)


def _cross_block(x, cp, patches, cfg: ModelConfig,
                 plan: Optional[MeshPlan] = None):
    h = rms_norm(x, cp["ln"], cfg.norm_eps)
    w, a, split = _attn_weights(cp, cfg, plan, _cross(plan))
    h = attn.tp_cross_attention(h, patches, w, a, split, _mesh(plan),
                                cfg.attn_chunk_q, cfg.attn_chunk_k)
    return x + _gate(cp, x) * h


def _gate(cp, x):
    return torch.tanh(cp["gate"].to(_F32)).to(x.dtype)


def _patches(extra, cfg: ModelConfig) -> torch.Tensor:
    if extra is None or "patches" not in extra:
        raise ValueError(f"{cfg.name} (vlm) needs extra['patches'] "
                         f"[B, {cfg.n_patches}, {cfg.d_model}]")
    return extra["patches"]


def _groups(cfg: ModelConfig, k: int):
    """(start, end) of each group of k layers, then the remainder."""
    n = cfg.n_layers // k
    out = [(g * k, (g + 1) * k) for g in range(n)]
    if cfg.n_layers > n * k:
        out.append((n * k, cfg.n_layers))
    return out


# ================================================================== mesh
def _mesh(plan: Optional[MeshPlan]):
    return None if plan is None else plan.mesh


def _cross(plan: Optional[MeshPlan]):
    """A vlm cross layer's shardings (None without a plan)."""
    return None if plan is None else plan.cross


def _keep(split: bool) -> Tuple[str, ...]:
    return ("model",) if split else ()


def _embed(params, tokens, plan: Optional[MeshPlan]):
    """The embedding rows of ``tokens``; on a mesh from the rank's
    ``vocab`` block: rows it does not hold are zero, and the sum over
    ``model`` fills them (the JAX ``constrain`` of the embedding's
    output)."""
    if plan is None:
        return params["embed"][tokens]
    mesh = plan.mesh
    w = tp.materialize(params["embed"], plan.shardings["embed"].spec, mesh,
                       _keep(plan.vocab))
    if not plan.vocab:
        return w[tokens]
    vl = w.shape[0]
    t = tokens - tp.axis_index(mesh, "model") * vl
    own = (t >= 0) & (t < vl)
    e = torch.where(own[..., None], w[t.clamp(0, vl - 1)],
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return tp.reduce_from(e, mesh, "model")


def _unembed(params, cfg: ModelConfig, plan: Optional[MeshPlan]):
    """The unembedding (the rank's ``vocab`` block where it splits)."""
    key = "embed" if cfg.tie_embeddings else "unembed"
    if plan is None:
        return params[key]
    return tp.materialize(params[key], plan.shardings[key].spec, plan.mesh,
                          _keep(plan.vocab))


def _sh(plan: Optional[MeshPlan], sh, key: str):
    """The shardings of ``key`` in a block's (``sh``, default a stacked
    layer's) on a mesh (None without one)."""
    if plan is None:
        return None
    return (plan.layer if sh is None else sh)[key]


def _attn_weights(lp, cfg: ModelConfig, plan: Optional[MeshPlan], sh=None,
                  key: str = "attn"):
    """(weights, config, heads split) of a block's attention ``key``:
    ``attention.local_attention`` on a mesh (``sh`` the block's
    shardings, default a stacked layer's), the block's own without."""
    if plan is None:
        return lp[key], cfg.attn, False
    return attn.local_attention(lp[key], _sh(plan, sh, key), cfg.attn,
                                plan.mesh)


def _mlp(h, p, cfg: ModelConfig, plan: Optional[MeshPlan], sh):
    """The MLP of weights ``p`` (shardings ``sh`` on a mesh)."""
    if plan is None:
        return swiglu(h, p, cfg.act)
    split = _splits(sh["w_up"], 1)
    w = {k: tp.materialize(v, sh[k].spec, plan.mesh, _keep(split))
         for k, v in p.items()}
    return tp_swiglu(h, w, cfg.act, split, plan.mesh)


# ================================================================= forward
def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            plan: Optional[MeshPlan] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, L] -> (hidden [B, L, D], aux_loss f32)."""
    _check_family(cfg)
    l = tokens.shape[1]
    x = constrain(_embed(params, tokens, plan), "batch", "seq", None)
    positions = torch.arange(l, dtype=torch.int32, device=x.device)
    windows = _windows_for(cfg)
    fam = cfg.family
    aux = torch.zeros((), dtype=_F32, device=x.device)
    dense = remat(_dense_block, cfg.remat)
    if fam == "dense":
        for i in range(cfg.n_layers):
            x = dense(x, layer_params(params, i), cfg, positions, windows[i],
                      plan)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        patches = _patches(extra, cfg).to(x.dtype)
        cross = remat(_cross_block, cfg.remat)
        for g in range(cfg.n_layers // k):
            for i in range(g * k, (g + 1) * k):
                x = dense(x, layer_params(params, i), cfg, positions,
                          windows[i], plan)
            x = cross(x, _slice(params["cross_layers"], g), patches, cfg,
                      plan)
    elif fam == "moe":
        moe = remat(_moe_block, cfg.remat)
        for i in range(cfg.n_layers):
            x, a = moe(x, layer_params(params, i), cfg, positions,
                       windows[i], plan)
            aux = aux + a
    elif fam == "ssm":
        ssm = remat(_ssm_block, cfg.remat)
        for i in range(cfg.n_layers):
            x = ssm(x, layer_params(params, i), cfg, plan)
    else:  # hybrid
        k = cfg.hybrid_attn_every
        ssm = remat(_ssm_block, cfg.remat)
        shared = None if plan is None else plan.shardings["shared_attn"]
        for lo, hi in _groups(cfg, k):
            for i in range(lo, hi):
                x = ssm(x, layer_params(params, i), cfg, plan)
            if hi - lo == k:
                x = dense(x, params["shared_attn"], cfg, positions,
                          BIG_WINDOW, plan, shared)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               plan: Optional[MeshPlan] = None):
    """Mean next-token nll plus the MoE aux loss -> (loss, {"nll",
    "aux"}).  ``batch`` has ``tokens`` and ``targets`` [B, L], optionally
    ``mask`` [B, L], and vlm's ``patches``.  On a mesh, the rank's part
    of the global mean (``mean_nll``)."""
    x, aux = forward(params, batch["tokens"].long(), cfg, extra=batch,
                     plan=plan)
    nll = mean_nll(params, x, batch, cfg, plan)
    return nll + aux, {"nll": nll, "aux": aux}


def mean_nll(params, x, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
             plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """The mean nll of hidden states x [B, L, D] over ``batch``'s
    ``targets`` (and ``mask``), logits scaled by ``d_model^-0.5`` where
    the embeddings are tied; on a mesh, the rank's part of the global
    mean: its rows' nll sum over the mask's count summed over the batch
    axes."""
    scale = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    total, count = xent_sums(
        x, _unembed(params, cfg, plan), batch["targets"], cfg.loss_chunk,
        logit_softcap=cfg.logit_softcap, mask=batch.get("mask"),
        logit_scale=scale, mesh=_mesh(plan),
        vocab_split=plan is not None and plan.vocab)
    if plan is not None and plan.batch_axes:
        count = tp.all_reduce(count.detach().clone(), plan.mesh,
                              plan.batch_axes)
    return total / torch.clamp(count, min=1.0)


# ================================================================== decode
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device, plan: Optional[MeshPlan] = None
                      ) -> Dict[str, torch.Tensor]:
    """The JAX decode state, all zero: ``cache_len`` i32[B]; dense, moe
    and vlm ``k_cache``/``v_cache`` [L, B, max_len, KH, Dh] in the compute
    dtype; vlm ``cross_k``/``cross_v`` [L / cross_attn_every, B,
    n_patches, KH, Dh]; ssm and hybrid ``ssm_h`` (f32) and ``ssm_conv``;
    hybrid one K/V cache per group, [L / hybrid_attn_every, B, max_len,
    KH, Dh]; encdec's (``models.encdec.init_decode_state``) likewise.  On
    a mesh, the rank's shard of the state of ``batch`` rows over the mesh
    (``state_sharding``)."""
    _check_known_family(cfg)
    leaves = _state_leaves(cfg, batch, max_len)
    if plan is None:
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in leaves.items()}
    sh = state_sharding(cfg, plan.mesh, batch, max_len)
    return {k: torch.zeros(sh[k].local_shape(shape), dtype=dt,
                           device=device)
            for k, (shape, dt) in leaves.items()}


def _attn_decode_block(x, lp, cfg: ModelConfig, kc, vc, new_len, window,
                       plan: Optional[MeshPlan] = None, sh=None):
    """One dense (or moe) block in decode mode: the new token's K/V is
    written into kc/vc [B, S, KH, Dh] at ``new_len - 1``, in place (on a
    mesh, the rank's heads into its cache shard; ``sh`` the block's
    shardings, default a stacked layer's)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    w, a, split = _attn_weights(lp, cfg, plan, sh)
    k_new, v_new = attn.project_new_kv(h, w, a, new_len - 1)
    attn.write_new_kv(kc, vc, k_new, v_new, new_len - 1)
    h = attn.tp_decode_attention(h, w, a, split, _mesh(plan), kc, vc,
                                 new_len, window)
    x = x + h
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        h, _aux = _moe_ffn(h, lp, cfg, plan)
    else:
        h = _mlp(h, lp["mlp"], cfg, plan, _sh(plan, sh, "mlp"))
    return x + h


def _ssm_decode(x, params, state, cfg: ModelConfig, i, nh, nconv,
                plan: Optional[MeshPlan] = None):
    lp = layer_params(params, i)
    hn = rms_norm(x, lp["ln"], cfg.norm_eps)
    w, ctx = _mamba(lp, cfg, plan)
    y, st = ssm_mod.mamba_decode_step(
        hn, {"h": state["ssm_h"][i], "conv": state["ssm_conv"][i]},
        w, cfg.d_model, cfg.ssm, ctx)
    nh[i] = st["h"]
    nconv[i] = st["conv"]
    return x + y


def logits_of(params, x: torch.Tensor, cfg: ModelConfig,
              plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """Unembedding of hidden states x [..., D] (scaled by D^-0.5 where the
    embeddings are tied), in the compute dtype; on a mesh, the rank's
    rows over the whole vocabulary."""
    scale = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    logits = (x * scale) @ _unembed(params, cfg, plan).T
    if plan is None or not plan.vocab:
        return logits
    logits = constrain(logits, *(("batch",) * (logits.dim() - 1)), "vocab")
    return tp.all_gather(logits, plan.mesh, "model", -1)


def decode_step(params, state, tokens: torch.Tensor, cfg: ModelConfig,
                extra: Optional[Dict[str, torch.Tensor]] = None,
                plan: Optional[MeshPlan] = None):
    """tokens [B, 1] -> (logits f32[B, V], new_state).  Writes the K/V
    caches of ``state`` in place (see the module docstring); ``extra`` is
    not read (the vlm cross K/V is in the state)."""
    _check_family(cfg)
    x = constrain(_embed(params, tokens, plan), "batch", None, None)
    new_len = state["cache_len"] + 1
    windows = _windows_for(cfg)
    fam = cfg.family
    new_state = dict(state)
    if fam in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x = _attn_decode_block(x, layer_params(params, i), cfg,
                                   state["k_cache"][i], state["v_cache"][i],
                                   new_len, windows[i], plan)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        plen = torch.full_like(new_len, cfg.n_patches)
        for g in range(cfg.n_layers // k):
            for i in range(g * k, (g + 1) * k):
                x = _attn_decode_block(
                    x, layer_params(params, i), cfg, state["k_cache"][i],
                    state["v_cache"][i], new_len, windows[i], plan)
            cp = _slice(params["cross_layers"], g)
            h = rms_norm(x, cp["ln"], cfg.norm_eps)
            w, a, split = _attn_weights(cp, cfg, plan, _cross(plan))
            h = attn.tp_decode_attention(h, w, a, split, _mesh(plan),
                                         state["cross_k"][g],
                                         state["cross_v"][g], plen,
                                         use_rope=False)
            x = x + _gate(cp, x) * h
    else:  # ssm, hybrid
        nh = torch.empty_like(state["ssm_h"])
        nconv = torch.empty_like(state["ssm_conv"])
        k = cfg.hybrid_attn_every if fam == "hybrid" else cfg.n_layers
        shared = (None if plan is None or fam != "hybrid"
                  else plan.shardings["shared_attn"])
        for g, (lo, hi) in enumerate(_groups(cfg, k)):
            for i in range(lo, hi):
                x = _ssm_decode(x, params, state, cfg, i, nh, nconv, plan)
            if fam == "hybrid" and hi - lo == k:
                x = _attn_decode_block(x, params["shared_attn"], cfg,
                                       state["k_cache"][g],
                                       state["v_cache"][g], new_len,
                                       BIG_WINDOW, plan, shared)
        new_state["ssm_h"], new_state["ssm_conv"] = nh, nconv
    new_state["cache_len"] = new_len
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_of(params, x[:, 0], cfg, plan).to(_F32)
    return softcap(logits, cfg.logit_softcap), new_state


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            plan: Optional[MeshPlan] = None):
    """Run the full prompt and build the decode state.  Returns (state,
    logits [B, V] in the compute dtype, no softcap, as the reference).
    The self-attention caches and the recurrent state stay zero (see the
    module docstring); vlm's cross K/V is computed from the patches.  On
    a mesh, ``tokens`` are the rank's rows and the state its shard."""
    b, l = tokens.shape
    state = init_decode_state(cfg, b * (1 if plan is None else plan.dp),
                              max_len, tokens.device, plan)
    x, _ = forward(params, tokens, cfg, extra=extra, plan=plan)
    if cfg.family == "vlm":
        patches = _patches(extra, cfg)
        for g in range(cfg.n_layers // cfg.cross_attn_every):
            w, a, _split = _attn_weights(_slice(params["cross_layers"], g),
                                         cfg, plan, _cross(plan))
            # the patches as given (f32 or not); on a mesh the rank's
            # kv heads
            attn.fill_cross_kv(state["cross_k"][g], state["cross_v"][g],
                               patches, w, a)
    state["cache_len"] = torch.full((b,), l, dtype=torch.int32,
                                    device=tokens.device)
    return state, logits_of(params, x[:, -1], cfg, plan)
