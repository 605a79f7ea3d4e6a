"""Roofline of one H100: the card's published peaks, a work counter over
meta tensors, the depth probes and the per-card terms of a dry-run cell.

Port of ``repro.utils.roofline``, on a design of its own.  The JAX
roofline reads XLA's ``cost_analysis``, which counts each loop body once,
so it compiles loop-free probes at two depths and extrapolates.  Eager
PyTorch runs every chunk of every loop, so a count taken op by op is
exact, and it does not fuse: every aten op reads its inputs from device
memory and writes its outputs there, so inputs plus outputs per op is
the port's real traffic (up to L2 hits).  ``WorkCounter`` takes that
count over a run on ``torch.device("meta")``, where nothing is
allocated:

* FLOPs per unit, from ``torch.utils.flop_counter``'s formulas: bf16 and
  f16 products against the tensor cores' peak, f32 products against
  the FP32 peak, or TF32's when ``torch.backends.cuda.matmul.allow_tf32``
  is set (the training attention runs f32 with TF32 off);
* bytes: inputs plus outputs of every op that is not a view (an
  allocation alone moves nothing), except where an index picks the
  elements: a gather (``index``, ``index_select``, ``gather``,
  ``embedding``) reads its indices and the rows it picks and writes
  them; an indexed write in place (``index_put_``, ``scatter_``, ...)
  reads its indices and values and writes the values, never the rest of
  its target (a decode step's K/V write touches one row of the cache);
* exponentials: one per output element of a transcendental op, against
  the SFU rate;
* the peak of live storage bytes, each storage counted from the op that
  made it until it dies.

The kernel wrappers add their kernel's own work on meta
(``kernels.counters.count_work``): the same work functions that
``chip_smoke.py`` bounds the kernels by.

Depth probes stay, for time rather than for XLA: a full-depth
``prefill_32k`` pass on meta runs thousands of chunk pairs a layer.
Serving counts are affine in depth, training's quadratic (``run_probe``);
the fit is exact for FLOPs, bytes and exponentials, and the peak's
within a few small transients.

On a mesh (``launch.dryrun --mesh``) the artifact carries the rank's
collective bytes by axis (``collective_bytes``, ``<kind>@<axis>``);
``collective_s`` is each axis's bytes over its link: ``NVLINK_BW``
(900 GB/s, the H100 SXM5 data sheet's NVLink bandwidth a GPU) for an
axis whose ranks lie inside one 8-card node, ``NIC_BW`` (50 GB/s: DGX
H100's one 400 Gb/s ConnectX-7 NIC a GPU) for one that crosses nodes.
Ranks are laid out row-major over the mesh, so an axis of size ``s``
and stride ``t`` (the product of the later axes' sizes) stays inside a
node when ``s * t <= 8``.  Without a mesh ``collective_s`` is 0.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["PEAK_BF16", "PEAK_FP32", "PEAK_TF32", "HBM_BW", "HBM_BYTES",
           "SFU_PER_S", "SFU_PER_SM_PER_CLOCK", "FP32_PER_SM_PER_CLOCK",
           "PEAKS", "NVLINK_BW", "NIC_BW", "NODE_CARDS", "link_bw",
           "collective_seconds", "WorkCounter", "probe_depths",
           "probe_config", "run_probe", "corrected_totals",
           "flash_onchip_bytes", "model_flops", "analyze_artifact"]

# NVIDIA's H100 SXM5 80GB data sheet, dense rates at 700 W
PEAK_BF16 = 989e12           # bf16 and f16 tensor cores, FLOP/s
PEAK_TF32 = 494.7e12         # TF32 tensor cores, FLOP/s
PEAK_FP32 = 66.9e12          # FP32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # device memory, bytes/s
HBM_BYTES = 80e9             # device memory, bytes
# per SM per clock on compute capability 9.0 (the CUDA C++ Programming
# Guide's table of arithmetic instruction throughput): exp2 results (one
# MUFU.EX2 per accurate expf), and FP32 lanes (one issue slot per
# rounded multiply or add, two FLOPs per FMA)
SFU_PER_SM_PER_CLOCK = 16
FP32_PER_SM_PER_CLOCK = 128
# exp2 results per second: 132 SMs x 16 a clock x 1.98 GHz (max SM clock)
SFU_PER_S = 132 * SFU_PER_SM_PER_CLOCK * 1.98e9
PEAKS = {"bf16": PEAK_BF16, "tf32": PEAK_TF32, "f32": PEAK_FP32}
# links between cards: NVLink 4 inside a node (the H100 SXM5 data sheet,
# 900 GB/s a GPU), one 400 Gb/s NIC a GPU across nodes (DGX H100)
NVLINK_BW = 900e9            # bytes/s
NIC_BW = 50e9                # bytes/s
NODE_CARDS = 8


def link_bw(mesh: Dict[str, int], axis: str) -> float:
    """The link an axis of a row-major mesh (``{axis: size}`` in order)
    runs on: NVLink inside a node, the NIC across nodes."""
    names = list(mesh)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= mesh[a]
    return NVLINK_BW if mesh[axis] * stride <= NODE_CARDS else NIC_BW


def collective_seconds(art: Dict, coll: Optional[Dict] = None) -> float:
    """Each axis's counted collective bytes over its link (0 without a
    mesh)."""
    mesh = art.get("mesh")
    coll = art.get("collective_bytes", {}) if coll is None else coll
    if not mesh:
        return 0.0
    return sum(v / link_bw(mesh, k.split("@")[1]) for k, v in coll.items()
               if "@" in k and not k.startswith("n_"))

_aten = torch.ops.aten
# ops that allocate and write nothing
_ALLOC_ONLY = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}
# one SFU result per output element
_TRANSCENDENTAL = {getattr(_aten, n) for n in (
    "exp", "exp_", "exp2", "expm1", "log", "log1p", "log2", "tanh", "tanh_",
    "sigmoid", "silu", "gelu", "softplus", "_softmax", "_log_softmax",
    "rsqrt", "sqrt", "sin", "cos", "erf", "logsumexp")}
_HALF = (torch.bfloat16, torch.float16)
# reads of the picked rows only: indices, plus the output read and written
_GATHER = {getattr(_aten, n) for n in ("index", "index_select", "gather",
                                       "embedding", "take")}
# writes of the picked rows only, in place: indices and values read, values
# written
_SCATTER_ = {getattr(_aten, n) for n in (
    "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
    "scatter_reduce_", "index_add_", "index_copy_", "index_fill_")}
# bytes held at a moment, not moved: fitted affine in depth
_HELD = ("peak_bytes", "argument_bytes")


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class WorkCounter(TorchDispatchMode):
    """Counts the work of everything run under it (see the module
    docstring).  ``begin_step()`` zeroes the counts and takes the live
    bytes as the step's arguments, so what was made before (parameters,
    optimizer state, caches, inputs) is held but not counted as work;
    ``result()`` gives the counts."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self._storages: Dict[int, int] = {}
        self.begin_step()

    def begin_step(self) -> None:
        self.flops: Dict[str, float] = collections.defaultdict(float)
        self.bytes = 0
        self.exps = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.argument_bytes = self.live
        self.peak = self.live

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_view(func):
            return out
        self.ops += 1
        outs = _tensors(out)
        inplace = any(r.alias_info is not None
                      for r in func._schema.returns)
        if not inplace:
            for t in outs:
                self._alloc(t)
        if func in _ALLOC_ONLY:
            return out
        ins = _tensors((args, kwargs))
        pkt = func._overloadpacket
        if pkt in _GATHER:
            self.bytes += (sum(map(_nbytes, ins[1:]))
                           + 2 * sum(map(_nbytes, outs)))
        elif pkt in _SCATTER_:
            self.bytes += 2 * sum(map(_nbytes, ins[1:]))
        else:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if pkt in flop_registry:
            x = ins[0]
            unit = ("bf16" if x.dtype in _HALF
                    else "tf32" if torch.backends.cuda.matmul.allow_tf32
                    else "f32")
            self.flops[unit] += flop_registry[pkt](*args, **kwargs,
                                                   out_val=out)
        elif pkt in _TRANSCENDENTAL:
            src = ins[0] if pkt in (_aten._softmax, _aten._log_softmax,
                                    _aten.logsumexp) else outs[0]
            self.exps += src.numel()
        return out

    def add_kernel_work(self, name: str, work: Dict[str, int]) -> None:
        """A kernel wrapper's meta call: its work function's counts."""
        row = self.kernels.setdefault(name, collections.defaultdict(int))
        row["calls"] += 1
        for k, v in work.items():
            row[k] += v
        self.bytes += work["bytes"]
        self.exps += work.get("exps", 0)
        self.flops["f32"] += work.get("flops_f32", 0)

    def result(self) -> Dict[str, float]:
        """One flat row: ``flops_<unit>``, ``bytes``, ``exps``,
        ``peak_bytes``, ``argument_bytes``, ``ops`` and, per kernel,
        ``<kernel>.<field>`` (its calls and work)."""
        row = {f"flops_{u}": float(self.flops.get(u, 0.0)) for u in PEAKS}
        row.update(bytes=float(self.bytes), exps=float(self.exps),
                   peak_bytes=float(self.peak),
                   argument_bytes=float(self.argument_bytes),
                   ops=float(self.ops))
        for name, work in self.kernels.items():
            row.update({f"{name}.{k}": float(v) for k, v in work.items()})
        return row


# ------------------------------------------------------------ depth probes
def probe_depths(cfg) -> Tuple[int, int]:
    """Two probe depths honouring group structure (hybrid/vlm)."""
    if cfg.family == "hybrid":
        u = cfg.hybrid_attn_every
    elif cfg.family == "vlm":
        u = cfg.cross_attn_every
    else:
        u = 1
    return u, 2 * u


def probe_config(cfg, n_layers: int):
    """cfg at another depth; chunks and everything else kept (eager runs
    every loop, so nothing needs to be unrolled)."""
    changes = dict(n_layers=n_layers)
    if cfg.family == "encdec":
        changes["n_enc_layers"] = n_layers
    return dataclasses.replace(cfg, **changes)


def run_probe(cfg, count: Callable[[object], Dict[str, float]],
              train: bool = False) -> Dict:
    """``count(probe_config(cfg, L))`` (a ``WorkCounter`` row of one
    step at depth L) at ``cfg``'s probe depths: {"depths", "rows",
    "fixed", "per_layer", "per_layer2"}, every key of the row fitted in
    depth.  Serving is affine in depth (``probe_depths``).  Training
    (``train``) is not: the backward of each layer's slice of a stacked
    ``[n_layers, ...]`` leaf writes a gradient of the whole stack
    (``select_backward``), so its bytes grow as depth squared; a third
    depth, 3u, makes that fit exact too.  The held bytes (the peak and the arguments) are affine through
    the two deepest probes: at one layer the peak's moment can differ
    (internlm2-1.8b trains at 9.34, 10.22, 10.99, 11.76 GB at 1-4 layers
    and batch 1)."""
    depths = list(probe_depths(cfg))
    if train:
        depths.append(3 * depths[0])
    rows = {L: count(probe_config(cfg, L)) for L in depths}
    keys = sorted(set().union(*rows.values()))
    u = depths[0]
    r = [{k: rows[L].get(k, 0.0) for k in keys} for L in depths]
    c0, c1, c2 = {}, {}, {}
    for k in keys:
        if len(depths) == 3 and k not in _HELD:
            c2[k] = (r[2][k] - 2 * r[1][k] + r[0][k]) / (2 * u * u)
            c1[k] = (r[1][k] - r[0][k]) / u - 3 * u * c2[k]
            c0[k] = r[0][k] - c1[k] * u - c2[k] * u * u
        else:   # affine through the two deepest probes
            i = len(depths) - 2
            c2[k] = 0.0
            c1[k] = (r[i + 1][k] - r[i][k]) / u
            c0[k] = r[i][k] - c1[k] * depths[i]
    return {"depths": depths, "rows": {str(L): rows[L] for L in depths},
            "fixed": c0, "per_layer": c1, "per_layer2": c2}


def corrected_totals(art: Dict, probe: Optional[Dict]) -> Dict[str, float]:
    """The probe's fit at the cell's depth ``art["n_layers"]``; without
    a probe, the artifact's own counts."""
    if probe is None:
        return {**art["counts"], "corrected": False}
    L = art["n_layers"]
    out = {k: max(probe["fixed"][k] + probe["per_layer"][k] * L
                  + probe["per_layer2"][k] * L * L, 0.0)
           for k in probe["fixed"]}
    return {**out, "corrected": True}


def flash_onchip_bytes(arch: str, shape_name: str, batch: float) -> float:
    """The [B, H, Lq, Lk] f32 score traffic a fused attention kernel
    would keep on chip (write and read forward, ~2x that backward), per
    card at ``batch`` rows.  The eager port writes these bytes, so they
    are reported beside the count, never taken from it."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if cfg.attn is None or shape.kind == "decode":
        return 0.0
    b_local = max(batch, 1)
    h = cfg.attn.n_heads
    lq = lk = shape.seq_len
    causal = 0.5
    passes = 6.0 if shape.kind == "train" else 2.0  # fwd w+r; bwd ~2x
    per_layer = passes * causal * b_local * h * lq * lk * 4.0
    if cfg.family == "hybrid":
        n_att = cfg.n_layers // cfg.hybrid_attn_every
    elif cfg.family == "encdec":
        # encoder (non-causal, enc_seq) + decoder self + cross
        enc = passes * b_local * h * cfg.enc_seq ** 2 * 4.0
        cross = passes * b_local * h * lq * cfg.enc_seq * 4.0
        return cfg.n_enc_layers * enc + cfg.n_layers * (per_layer + cross)
    else:
        n_att = cfg.n_layers
    extra = 0.0
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        extra = n_cross * passes * b_local * h * lq * cfg.n_patches * 4.0
    return n_att * per_layer + extra


def model_flops(art: Dict) -> float:
    """Useful-work floor: 6*N*D train / 2*N*D inference (per step, global)."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(art["arch"])
    shape = SHAPES[art["shape"]]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def analyze_artifact(art: Dict) -> Dict:
    """A dry-run artifact's per-card roofline terms: ``compute_s`` (each
    unit's FLOPs over its peak, plus exponentials over the SFU rate),
    ``memory_s`` (bytes over HBM), ``bound``, ``step_s``, the useful and
    roofline fractions (the global model FLOPs against all ``cards``) and
    ``fits`` (the peak within ``HBM_BYTES``)."""
    tot = corrected_totals(art, art.get("probe"))
    compute = {u: tot.get(f"flops_{u}", 0.0) / peak
               for u, peak in PEAKS.items()}
    sfu_s = tot.get("exps", 0.0) / SFU_PER_S
    compute_s = sum(compute.values()) + sfu_s
    memory_s = tot["bytes"] / HBM_BW
    collective_s = collective_seconds(art)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    step_s = max(terms.values())
    cards = art["cards"]
    mf = model_flops(art)
    flops = sum(tot.get(f"flops_{u}", 0.0) for u in PEAKS)
    return {
        "arch": art["arch"], "shape": art["shape"], "kind": art["kind"],
        "batch": art["batch"], "cards": cards,
        "compute_s": compute_s, "compute_bf16_s": compute["bf16"],
        "compute_f32_s": compute["f32"] + compute["tf32"], "sfu_s": sfu_s,
        "memory_s": memory_s, "collective_s": collective_s, "bound": bound,
        "mesh": "x".join(str(n) for n in art["mesh"].values())
        if art.get("mesh") else "1",
        "collective_bytes": art.get("collective_bytes", {}).get("total",
                                                                0.0),
        "step_s": step_s, "model_flops": mf,
        "useful_frac": mf / (flops * cards) if flops else 0.0,
        "roofline_frac": (mf / step_s / (PEAK_BF16 * cards)
                          if step_s else 0.0),
        "peak_bytes": tot["peak_bytes"],
        "fits": tot["peak_bytes"] <= HBM_BYTES,
        "onchip_bytes": flash_onchip_bytes(art["arch"], art["shape"],
                                           art["batch"]),
        "corrected": tot["corrected"],
    }
