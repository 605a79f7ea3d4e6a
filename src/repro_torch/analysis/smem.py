"""Contract 3 — the shared-memory proof (DESIGN.md §15).

Port of ``repro.analysis.vmem``: Hopper has no VMEM, and the on-chip
budget a kernel can overrun is its block's shared memory.  The model
gives each serving kernel's static plus dynamic shared memory per
block, transcribed from the sources and wrappers:

* ``fused_lookup_kernel``: static ``s_q``, ``s_hi``, ``s_lo``,
  ``s_tier``, HALF (128) entries of 4 bytes each
  (``csrc/fused_lookup.cu:269-270``);
* ``range_scan_kernel``: static ``Slot slots[WARPS][32]``, 8 x 32 x 20
  bytes (``csrc/range_scan.cu:119``);
* ``streamed_lookup_kernel``: static ``s_tier[2][HALF]`` with HALF 512
  (``csrc/streamed_lookup.cu:198``), plus the router staged as dynamic
  memory: the wrapper asks for ``r_smem`` entries
  (``streamed_lookup.py:283``) and the C launcher caps them at what fits
  beside the static part, a multiple of 4 (``csrc/streamed_lookup.cu``,
  ``streamed_lookup_launch``) — past that the router is staged only in
  part, the documented cliff;
* ``mamba_scan_kernel``: dynamic, two stages of dt, x (``chunk`` x 32
  channels), B and C (``chunk`` x N) and the lanes' sums of y, the
  chunk from ``mamba_scan.scan_plan`` (``mamba_scan.py:75-79``; the
  launcher's ``bytes``);
* ``decode_split_kernel``: dynamic, ``Layout.total`` of
  ``csrc/flash_decode.cu`` (rings of K/V tiles, q, p, m and l), whose
  launcher raises its limit itself;
* ``nf_forward_*``, ``index_probe_kernel``, ``decode_combine_kernel``:
  none.

``run_smem_checks`` evaluates the model over a declared grid (scan-pool
capacities 2^17 to 2^26 rows; falcon-mamba-7b's and the smoke config's
scan widths, and every state size the kernel takes; decode attention at
the port's head dims and cache dtypes) against the per-block limit:
232,448 bytes on the H100, read on the card from
``cudaDevAttrMaxSharedMemoryPerBlockOptin``.  A config that cannot
launch is an error; a router staged only in part is ``info`` at the
row count where that starts.  On the card, the model is cross-checked:
the static part against each kernel's ptxas log, and the total against
the profiler's ``shared memory`` of every launch; any disagreement is an
``smem:model-drift`` finding, as ``vmem.py``'s ``model-drift`` is.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding, Report

__all__ = ["SMEM_LIMIT", "STATIC", "streamed_router",
           "mamba_bytes", "decode_bytes", "model", "router_cliff_rows",
           "SmemConfig", "SMEM_GRID", "run_smem_checks",
           "check_static_against_ptxas", "check_launches", "launch_params",
           "calibration_launches"]

SMEM_LIMIT = 232_448          # H100: shared memory a block can opt into
_HERE = Path(__file__).resolve()
_CSRC = _HERE.parents[1] / "kernels" / "csrc"

# static shared memory per block, bytes (see the module docstring)
STATIC: Dict[str, int] = {
    "fused_lookup_kernel": 4 * 128 * 4,
    "range_scan_kernel": 8 * 32 * 20,
    "streamed_lookup_kernel": 2 * 512 * 4,
    "mamba_scan_kernel": 0,
    "decode_split_kernel": 0,
    "decode_combine_kernel": 0,
    "nf_forward_vec4": 0,
    "nf_forward_scalar": 0,
    "index_probe_kernel": 0,
}
_LOC = {
    "fused_lookup_kernel": "fused_lookup.cu:269",
    "range_scan_kernel": "range_scan.cu:119",
    "streamed_lookup_kernel": "streamed_lookup.cu:198",
    "mamba_scan_kernel": "mamba_scan.cu:121",
    "decode_split_kernel": "flash_decode.cu:179",
}

STREAM_ALIGN = 1024            # streamed_lookup.py STREAM_ALIGN
_LANE = 128
CHANNEL_TILE = 32              # mamba_scan.cu CT
# flash_decode.cu
_TILE, _NSTG, _MAX_WARPS, _GMAX, _RING = 16, 2, 4, 8, 96 * 1024


def streamed_router(capacity: int, limit: int = SMEM_LIMIT
                    ) -> Tuple[int, int, int]:
    """The streamed kernel's router staging for a scan pool of
    ``capacity`` rows: ``(dynamic bytes, entries staged, entries
    needed)``.  The wrapper asks for the entries the bracket reads (one
    per tile and the next tile's start), rounded up to a multiple of 4
    and within the router's length; the launcher caps them at
    ``((limit - static) / 4) & ~3``."""
    need = -(-int(capacity) // STREAM_ALIGN) + 1
    n_slices = max(int(capacity) // STREAM_ALIGN, 1)
    router_len = ((n_slices + 1 + _LANE - 1) // _LANE) * _LANE
    r_smem = min(-(-need // 4) * 4, router_len)
    fit = ((limit - STATIC["streamed_lookup_kernel"]) // 4) & ~3
    r_smem = min(r_smem, fit)
    return 4 * r_smem, r_smem, need


def router_cliff_rows(limit: int = SMEM_LIMIT) -> int:
    """The smallest scan-pool capacity (rows) whose router no longer
    fits whole beside the streamed kernel's static shared memory."""
    fit = ((limit - STATIC["streamed_lookup_kernel"]) // 4) & ~3
    # need = ceil(cap / 1024) + 1 > fit  <=>  cap > (fit - 1) * 1024
    return (fit - 1) * STREAM_ALIGN + 1


def mamba_bytes(n: int) -> Tuple[int, int]:
    """``(dynamic bytes, chunk)`` of the scan kernel at state size ``n``,
    with the wrapper's plan (``scan_plan``) and the launcher's bytes."""
    from repro_torch.kernels.mamba_scan import scan_plan

    plan = scan_plan(1, 1, 1, n)
    g, chunk = plan.lanes, plan.chunk
    return (4 * (2 * (2 * chunk * CHANNEL_TILE + 2 * chunk * n)
                 + chunk * CHANNEL_TILE * g), chunk)


_DTYPE = {"float32": (4, 4), "bfloat16": (2, 8), "float16": (2, 8)}


def decode_bytes(d: int, dtype: str) -> int:
    """``Layout(D, sizeof(T), VEC).total`` of ``csrc/flash_decode.cu``."""
    elem, vec = _DTYPE[dtype]
    rb = d * elem
    nch = (rb + 15) // 16
    rsk, rsv = 16 * (nch | 1), 16 * nch
    stage = _TILE * (rsk + rsv)
    nw = min(max(_RING // (_NSTG * stage), 1), _MAX_WARPS)
    dp = nch * vec
    q = nw * _NSTG * stage
    pw = q + 4 * _GMAX * dp
    ml = pw + 4 * _MAX_WARPS * _GMAX * _TILE
    return ml + 4 * _MAX_WARPS * _GMAX * 2


def model(kernel: str, *, capacity: Optional[int] = None,
          n: Optional[int] = None, d: Optional[int] = None,
          dtype: Optional[str] = None, limit: int = SMEM_LIMIT) -> int:
    """Static plus dynamic shared memory of one launch of ``kernel``."""
    total = STATIC[kernel]
    if kernel == "streamed_lookup_kernel":
        total += streamed_router(capacity, limit)[0]
    elif kernel == "mamba_scan_kernel":
        total += mamba_bytes(n)[0]
    elif kernel == "decode_split_kernel":
        total += decode_bytes(d, dtype)
    return total


@dataclasses.dataclass(frozen=True)
class SmemConfig:
    """One declared launch shape the proof covers."""

    name: str
    kernel: str
    params: Tuple[Tuple[str, object], ...] = ()


def _grid() -> Tuple[SmemConfig, ...]:
    out = [SmemConfig("fused_lookup", "fused_lookup_kernel"),
           SmemConfig("range_scan", "range_scan_kernel")]
    out += [SmemConfig(f"streamed_lookup:2^{k}", "streamed_lookup_kernel",
                       (("capacity", 1 << k),)) for k in range(17, 27)]
    # falcon-mamba-7b and its smoke config both scan at state size 16;
    # the other sizes are the plan's edges (lanes and states per lane
    # change at powers of two; from N 65 on, only the fallback chunk of
    # 16 is left) up to the kernel's widest, 128
    out += [SmemConfig(f"mamba_scan:N={n}", "mamba_scan_kernel",
                       (("n", n),)) for n in (1, 8, 16, 17, 32, 64, 65, 128)]
    # decode attention at the port's head dims: qwen3-14b 128, the smoke
    # config 32, and the kernel's widest, 256
    out += [SmemConfig(f"flash_decode:D={d}:{dt}", "decode_split_kernel",
                       (("d", d), ("dtype", dt)))
            for d in (32, 128, 256) for dt in _DTYPE]
    return tuple(out)


SMEM_GRID: Tuple[SmemConfig, ...] = _grid()


def run_smem_checks(report: Optional[Report] = None, *,
                    limit: int = SMEM_LIMIT) -> dict:
    """The model over ``SMEM_GRID`` against ``limit``; returns ``{config:
    bytes}`` and the router's cliff."""
    report = report if report is not None else Report()
    out = {}
    for cfg in SMEM_GRID:
        params = dict(cfg.params)
        total = model(cfg.kernel, limit=limit, **params)
        out[cfg.name] = total
        loc = str(_CSRC / _LOC.get(cfg.kernel, f"{cfg.kernel}:1"))
        if total > limit:
            report.add(Finding(
                contract="smem", entry=cfg.name, location=loc,
                message=(f"cannot launch: {total} bytes of shared memory a "
                         f"block against the {limit}-byte limit"),
                details={"bytes": total, "limit": limit, **params}))
            continue
        report.note_pass(cfg.name, "smem")
        if cfg.kernel == "streamed_lookup_kernel":
            _dyn, staged, need = streamed_router(params["capacity"], limit)
            if staged < need:
                cliff = router_cliff_rows(limit)
                report.add(Finding(
                    contract="smem", entry=cfg.name,
                    location=str(_CSRC / "streamed_lookup.cu:198"),
                    severity="info",
                    message=(f"router staged in part: {staged} of {need} "
                             "entries fit in shared memory beside the "
                             f"kernel's {STATIC[cfg.kernel]} static bytes; "
                             "the rest is read from device memory.  The "
                             f"cliff starts at {cliff} rows"),
                    details={"staged": staged, "needed": need,
                             "cliff_rows": cliff}))
    out["router_cliff_rows"] = router_cliff_rows(limit)
    return out


def check_static_against_ptxas(report: Report, logs: Dict[str, str],
                               expect=()) -> List[dict]:
    """Every kernel instantiation's static shared memory in the build's
    ptxas logs (``{source: log}``) against the model's; a kernel of
    ``expect`` that no log records is an error (its static part went
    unchecked)."""
    from repro_torch.utils.ptx import kernel_base_name, parse_ptxas_log

    rows = []
    for source, log in logs.items():
        for sym, rec in parse_ptxas_log(log).items():
            base = kernel_base_name(sym)
            if base not in STATIC or "smem" not in rec:
                continue
            rows.append({"kernel": base, "symbol": sym,
                         "ptxas": rec["smem"], "model": STATIC[base]})
            if rec["smem"] != STATIC[base]:
                report.add(Finding(
                    contract="smem:model-drift", entry=base,
                    location=str(_CSRC / _LOC.get(base, f"{source}.cu:1")),
                    message=(f"model drift: ptxas gives {sym} "
                             f"{rec['smem']} static bytes, the model "
                             f"{STATIC[base]}"),
                    details=rows[-1]))
    for base in sorted(set(expect) - {r["kernel"] for r in rows}):
        report.add(Finding(
            contract="smem", entry=base,
            location=str(_CSRC / _LOC.get(base, f"{base}:1")),
            message=("no ptxas record: the build logs hold no "
                     f"instantiation of {base}, so its static shared "
                     "memory went unchecked"), details={}))
    if rows and all(r["ptxas"] == r["model"] for r in rows):
        report.note_pass("static-calibration", "smem")
    return rows


def check_launches(report: Report, launches: List[dict]) -> None:
    """Each launch's ``smem`` (the profiler's static plus dynamic bytes)
    against its ``model`` bytes (both keys set by the caller)."""
    for f in launches:
        if f["smem"] != f["model"]:
            report.add(Finding(
                contract="smem:model-drift", entry=f["kernel"],
                location=str(_CSRC / _LOC.get(f["kernel"],
                                              f"{f['kernel']}:1")),
                message=(f"model drift: the profiler measured "
                         f"{f['smem']} bytes of shared memory for a "
                         f"launch, the model {f['model']} "
                         f"({f.get('params', {})})"),
                details=dict(f)))
    if launches and all(f["smem"] == f["model"] for f in launches):
        report.note_pass("launch-calibration", "smem")


# -------------------------------------------------- card calibration
_WRAPPERS = {
    # kernel -> (wrapper module, wrapper name, params of one call)
    "streamed_lookup_kernel": (
        "repro_torch.kernels.streamed_lookup", "streamed_lookup",
        lambda a, k: {"capacity": int(a[4].pool.pk.shape[0])}),
    "mamba_scan_kernel": (
        "repro_torch.kernels.mamba_scan", "mamba_scan",
        lambda a, k: {"n": int(a[2].shape[2])}),
    "decode_split_kernel": (
        "repro_torch.kernels.flash_decode", "flash_decode",
        lambda a, k: {"d": int(a[0].shape[2]),
                      "dtype": str(a[1].dtype).replace("torch.", "")}),
}


class launch_params:
    """Context manager recording, per kernel whose shared memory depends
    on its call, the model's parameters of each wrapper call in call
    order (``self.calls[kernel]``), to pair with the profiler's launches
    of that kernel in launch order."""

    def __init__(self):
        self.calls: Dict[str, List[dict]] = {k: [] for k in _WRAPPERS}
        self._saved = []

    def __enter__(self):
        import importlib

        for kernel, (mod, name, params) in _WRAPPERS.items():
            m = importlib.import_module(mod)
            real = getattr(m, name)

            def wrapper(*a, _real=real, _k=kernel, _p=params, **k):
                out = _real(*a, **k)
                if a and getattr(a[0], "is_cuda", False):
                    self.calls[_k].append(_p(a, k))
                return out

            wrapper.__dict__ = real.__dict__
            self._saved.append((m, name, real))
            setattr(m, name, wrapper)
        return self

    def __exit__(self, *exc):
        for m, name, real in reversed(self._saved):
            setattr(m, name, real)
        self._saved.clear()
        return False

    def pair(self, facts: List[dict], limit: int = SMEM_LIMIT) -> List[dict]:
        """Set ``model`` (and ``params``) on every fact of a modelled
        kernel, pairing the i-th launch with the i-th call."""
        seen: Dict[str, int] = {}
        out = []
        for f in facts:
            k = f["kernel"]
            if k not in STATIC:
                continue
            params = {}
            if k in self.calls:
                i = seen.get(k, 0)
                seen[k] = i + 1
                if i >= len(self.calls[k]):
                    continue
                params = self.calls[k][i]
            out.append({**f, "params": params,
                        "model": model(k, limit=limit, **params)})
        return out


def calibration_launches(device) -> None:
    """One launch of each kernel whose dynamic shared memory the world
    does not reach at size: ``streamed_lookup`` over a scan pool of 2^25
    rows (nearly full, as ``tests/test_torch_kernels_cuda.py`` builds
    it), ``mamba_scan`` at falcon-mamba-7b's widths (d_inner 8,192, N
    16), ``flash_decode`` at qwen3-14b's attention shape (40 q heads, 8
    kv heads, D 128, bf16) over 1,024 positions."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.range_scan import ScanPool
    from repro_torch.kernels.streamed_lookup import (StreamPack, build_router,
                                                     streamed_lookup)

    dev = torch.device(device)
    cap = 1 << 25
    plen = cap - 1000
    pv = np.full(cap, -1, np.int32)
    pv[:plen] = np.arange(plen, dtype=np.int32)
    pk = pv.astype(np.float32)
    pk[plen:] = np.inf
    hi = (pv.view(np.uint32) * np.uint32(2654435761)).view(np.int32)
    pool = ScanPool(*(torch.from_numpy(x).to(dev) for x in (pk, hi, pv, pv)),
                    torch.tensor([plen], dtype=torch.int32, device=dev))
    sp = StreamPack(pool, build_router(pool.pk), window=2)
    pick = np.random.default_rng(3).integers(0, plen, 4096)
    got, _z = streamed_lookup(
        torch.from_numpy(pk[pick].reshape(-1, 1)).to(dev),
        torch.from_numpy(hi[pick]).to(dev), torch.from_numpy(pv[pick]).to(dev),
        None, sp, None, dim=1, use_flow=False)
    if not np.array_equal(got.cpu().numpy(), pick.astype(np.int32)):
        raise RuntimeError("streamed_lookup over the 2^25-row pool read "
                           "wrong rows")
    del pool, sp
    g = torch.Generator().manual_seed(9)
    b, l, di, n = 1, 64, 8192, 16
    dt = torch.rand(b, l, di, generator=g).mul_(0.1).to(dev)
    xi = torch.randn(b, l, di, generator=g).to(dev)
    b_in = torch.randn(b, l, n, generator=g).to(dev)
    c_out = torch.randn(b, l, n, generator=g).to(dev)
    a_log = torch.randn(di, n, generator=g).to(dev)
    ops.mamba_scan(dt, xi, b_in, c_out, a_log)
    q = torch.randn(1, 40, 128, generator=g).to(dev)
    kv = torch.randn(1, 1024, 8, 128, generator=g).to(dev, torch.bfloat16)
    ops.flash_decode(q, kv, kv, torch.tensor([1024], dtype=torch.int32,
                                             device=dev))
    torch.cuda.synchronize()
