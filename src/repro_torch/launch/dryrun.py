"""One-card dry run: what each (architecture x shape) cell needs of an
80 GB H100, counted on the meta device without a card.

Port of ``repro.launch.dryrun``, on a design of its own.  The JAX dry run
lowers and compiles each cell's step against 512 placeholder TPU devices
and reads XLA's memory and cost analyses.  Here the step itself (the
train step of ``make_train_step``, ``model.prefill``, or ``decode_step``
over a full cache) runs on ``torch.device("meta")`` under
``utils.roofline.WorkCounter``: every op's FLOPs, bytes and exponentials,
each kernel wrapper's work function, and the peak of live storage bytes,
with nothing allocated.  Counts are taken at the cell's two probe depths
and fitted in depth (``probe_cell``, ``roofline.run_probe``).

**On a mesh** (``--mesh 16x16:data,model``, the JAX production mesh;
``--multi-pod`` its (2, 16, 16) ``pod,data,model``; any ``dxm`` shape),
as the JAX dry run: every family, each rank at the global batch of
``SHAPES`` over the mesh's data-parallel ranks (its inputs, vlm
``patches`` and encdec ``frames`` among them, placed by
``model.input_sharding``), training at the JAX microbatch rule (at most
the rank's rows).  ``count_step`` counts rank 0's step on the meta device
under a fake process group of the mesh's size (``launch.mesh``): its
local shards (``param_sharding``, ``decode_state_specs``), the weights
it gathers and the collectives it calls, each counted in wire bytes by
kind and by axis (``tensor_parallel.collective_counts``, recorded as
the JAX ``collective_bytes``; the MoE expert counts' all-gather and the
Mamba layers' all-to-all among them), nothing moved.  The artifact
records the mesh, per-card FLOPs by unit, bytes, argument and peak
bytes, and what splits over ``model``: the attention heads
(``head_split``; where they do not, every rank holds and computes every
kv head: its cache and the gathered weights are in its bytes), the
experts (``experts_split``), the Mamba layers' ``d_inner``
(``ssm_split``) or, under ``SSMConfig.batch_tp`` (a config built with
``dataclasses.replace``: no architecture sets it), their rows
(``rows_split``).

Without a mesh, the one-card question is what batch a card holds.
With ``batch=None`` the dry run takes the largest power of two, up to
the global batch, whose predicted peak fits ``HBM_BYTES``: an affine
model in batch over two probe batches proposes it, and counts confirm
it (halved while a count says it does not fit, doubled while the model
and a count say the next one fits).  A cell
that does not fit even at batch 1 records ``fits: false`` and its bytes.
``cards`` is the global batch over the per-card batch.

Training runs the JAX dry run's microbatches (``TRAIN_MICROBATCHES``,
at most the per-card batch) and arctic-480b's Adafactor with bf16
accumulation; the metrics are not read back (``.tolist()`` has no values
on meta).  Mamba1 prefills go through the selective-scan kernel, as
``launch.serve`` sets them to.

Artifacts land in ``build/dryrun/<arch>__<shape>.json`` (on a mesh
``<arch>__<shape>__<d>x<m>.json``); the report is ``python -m
repro_torch.utils.report``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--batch B] [--layers N] [--microbatches M] [--out-dir DIR]
        [--mesh DxM:data,model | --multi-pod] [--continue-on-error]

``--layers`` cuts the depth (as ``chip_smoke.py`` cuts falcon-mamba-7b
to 32 layers), ``--microbatches`` overrides ``TRAIN_MICROBATCHES``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import place
from repro_torch.models.model import (build_model, decode_state_shapes,
                                      input_sharding, input_specs)
from repro_torch.models.transformer import mesh_plan
from repro_torch.train.optimizer import AdafactorConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step, state_sharding)
from repro_torch.utils.roofline import (HBM_BYTES, WorkCounter,
                                        corrected_totals, probe_config,
                                        run_probe)

__all__ = ["dryrun_cell", "count_step", "probe_cell", "train_config",
           "cell_config", "mesh_tag", "parse_mesh", "data_ways",
           "TRAIN_MICROBATCHES", "ARTIFACT_DIR"]

ARTIFACT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun"))

# gradient-accumulation microbatches per arch for train_4k, the JAX dry
# run's (loss-equivalent; one microbatch after another)
TRAIN_MICROBATCHES = {
    "arctic-480b": 16,
    "gemma2-9b": 2,
    "qwen3-14b": 2,
    "llama-3.2-vision-11b": 4,
    "zamba2-2.7b": 4,
}


def train_config(arch: str, batch: int,
                 microbatches: Optional[int] = None) -> TrainConfig:
    """The JAX dry run's train config at ``batch`` rows a card:
    ``microbatches`` (default ``TRAIN_MICROBATCHES``) cut to the batch;
    arctic-480b's Adafactor with bf16 accumulation, AdamW otherwise."""
    mb = min(microbatches or TRAIN_MICROBATCHES.get(arch, 1), batch)
    if arch == "arctic-480b":
        return TrainConfig(optimizer=AdafactorConfig(), microbatches=mb,
                           accum_dtype="bfloat16")
    return TrainConfig(microbatches=mb)


def cell_config(cfg, kind: str):
    """The config a step of ``kind`` runs: Mamba1 prefills through the
    scan kernel (``launch.serve``'s setting)."""
    if kind == "prefill" and cfg.ssm is not None and cfg.ssm.version == 1:
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, use_scan_kernel=True))
    return cfg


def _inputs(cfg, shape, batch: int, device: torch.device, mesh=None):
    """``input_specs`` at ``batch`` rows (on ``mesh``, the rank's block,
    ``input_sharding``, of the whole batch of a step whose rank holds
    ``batch`` rows); off meta, zeros of those shapes (token 0 is in
    every vocabulary)."""
    if mesh is None:
        ins = input_specs(cfg, dataclasses.replace(shape,
                                                   global_batch=batch))
    else:
        whole = dataclasses.replace(shape, global_batch=_mesh_rows(
            shape, batch, mesh))
        ins = place(input_specs(cfg, whole),
                    input_sharding(cfg, whole, mesh))
    if device.type == "meta":
        return ins
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in ins.items()}


def mesh_tag(mesh) -> str:
    return "x".join(str(int(n)) for n in mesh.shape)


def data_ways(mesh) -> int:
    """The mesh's data-parallel ranks (its batch axes' product)."""
    n = 1
    for a in tp.BATCH_AXES:
        n *= tp.axis_size(mesh, a)
    return n


def _mesh_rows(shape, batch: int, mesh) -> int:
    """The whole batch of a mesh step whose rank holds ``batch`` rows
    (the rank's rows, where the global batch does not split over the
    data ranks: every rank holds them)."""
    dp = data_ways(mesh)
    return batch if shape.global_batch % dp else batch * dp


def count_step(arch: str, cfg, shape, batch: int,
               microbatches: Optional[int] = None,
               device: str = "meta", mesh=None) -> Dict[str, float]:
    """One pass of the step of ``shape.kind`` at ``batch`` rows under a
    ``WorkCounter``, on meta (the dry run) or, at small sizes, on a real
    device: the parameters (and the optimizer state, or the decode
    state) and the inputs are made first and held as the step's
    arguments; then the step's work and peak (``WorkCounter.result``).
    On ``mesh``, ``batch`` is the rank's rows and everything made is the
    rank's shard (the whole tensors are made and dropped before the
    step); the row adds ``coll.<key>`` for each collective count."""
    cfg = cell_config(cfg, shape.kind)
    model = build_model(cfg, device=device, mesh=mesh)
    gen = torch.Generator(device="cpu" if model.device.type == "meta"
                          else model.device).manual_seed(0)
    with WorkCounter() as wc:
        if shape.kind == "train":
            tcfg = train_config(arch, batch, microbatches)
            state = init_train_state(model, gen, tcfg)
            if mesh is not None:
                state = place(state, state_sharding(model, state))
            ins = _inputs(cfg, shape, batch, model.device, mesh)
            wc.begin_step()
            tp.collective_counts(reset=True)
            make_train_step(model, tcfg)(state, ins)
        else:
            params = model.place(model.init(gen))
            ins = _inputs(cfg, shape, batch, model.device, mesh)
            extra = {k: v for k, v in ins.items() if k != "tokens"} or None
            if shape.kind == "prefill":
                wc.begin_step()
                tp.collective_counts(reset=True)
                with torch.no_grad():
                    model.prefill(params, ins["tokens"], shape.seq_len + 1,
                                  extra=extra)
            else:   # decode: the cache live at seq_len - 1, one token more
                if mesh is not None:
                    state = model.init_decode_state(
                        _mesh_rows(shape, batch, mesh), shape.seq_len)
                elif model.device.type == "meta":
                    state = decode_state_shapes(cfg, batch, shape.seq_len)
                else:
                    state = model.init_decode_state(batch, shape.seq_len)
                wc.begin_step()
                tp.collective_counts(reset=True)
                with torch.no_grad():
                    logits, _ = model.decode_step(params, state,
                                                  ins["tokens"], extra=extra)
                    torch.argmax(logits, -1)
        row = wc.result()
    coll = tp.collective_counts(reset=True)
    if mesh is not None:
        row.update({f"coll.{k}": float(v) for k, v in coll.items()})
    return row


def probe_cell(arch: str, shape_name: str, cfg, batch: int,
               microbatches: Optional[int] = None, mesh=None) -> Dict:
    """``run_probe`` of the cell's step (``count_step``) at ``batch``
    rows a card: its counts at ``cfg``'s probe depths, fitted in depth."""
    shape = SHAPES[shape_name]
    return run_probe(cfg, lambda c: count_step(arch, c, shape, batch,
                                               microbatches, mesh=mesh),
                     train=shape.kind == "train")


def _choose_batch(arch, shape_name, cfg, microbatches):
    """(batch, its probe, the search's record): the largest power of two
    up to the global batch whose counted peak fits.  Counts decide; an
    affine model in batch, through the two largest batches counted,
    spares counts.  Fitted first over the microbatch count and twice it
    (so each microbatch grows), it proposes the batch to count; that
    count confirms it or halves it; then, while the model predicts the
    next doubling to fit, a count again confirms it (a peak can grow
    slower than affine: MoE dispatch is cut into token chunks)."""
    shape = SHAPES[shape_name]
    g = shape.global_batch
    mb = (microbatches or TRAIN_MICROBATCHES.get(arch, 1)
          if shape.kind == "train" else 1)
    probes, peaks = {}, {}

    def fits(b):
        if b not in probes:
            probes[b] = probe_cell(arch, shape_name, cfg, b, microbatches)
            peaks[b] = corrected_totals({"n_layers": cfg.n_layers},
                                        probes[b])["peak_bytes"]
        return peaks[b] <= HBM_BYTES

    def predicted_fit(b):
        lo, hi = sorted(peaks)[-2:]
        return (peaks[hi] + (peaks[hi] - peaks[lo]) / (hi - lo) * (b - hi)
                <= HBM_BYTES)

    b1, b2 = min(mb, g), min(2 * mb, g)
    pick = b1
    if fits(b1) and b2 > b1 and fits(b2):
        pick = b2
        while pick * 2 <= g and predicted_fit(pick * 2):
            pick *= 2
    while pick > 1 and not fits(pick):
        pick //= 2
    while (pick * 2 <= g and fits(pick) and predicted_fit(pick * 2)
           and fits(pick * 2)):
        pick *= 2
    affine = ({"batches": [b1, b2], "peaks": [peaks[b1], peaks[b2]]}
              if b2 > b1 and b2 in peaks else None)
    record = {"affine": affine,
              "probed": {str(b): p for b, p in sorted(peaks.items())}}
    return pick, probes[pick], record


def _mesh_batch(arch, cfg, shape, mesh, microbatches, batch=None):
    """(rows a rank, its microbatch count) at the JAX global batch (or
    ``batch`` rows a rank, where one is given)."""
    dp = data_ways(mesh)
    if shape.global_batch % dp:
        if shape.kind != "decode" or cfg.family == "moe":
            raise ValueError(f"{arch}: a global batch of "
                             f"{shape.global_batch} does not split over "
                             f"{dp} data-parallel ranks")
        # every data rank holds every row, as guarded_spec places a batch
        # that does not split (long_500k's one row)
        return batch or shape.global_batch, 1
    batch = batch or shape.global_batch // dp
    mb = microbatches or TRAIN_MICROBATCHES.get(arch, 1)
    return batch, min(mb, max(batch, 1))


def dryrun_cell(arch: str, shape_name: str, batch: Optional[int] = None,
                cfg=None, save: bool = True,
                microbatches: Optional[int] = None,
                out_dir: Optional[str] = None, mesh=None) -> Dict[str, Any]:
    """One cell: the per-card batch (``batch``, or the largest that
    fits; on ``mesh`` ``batch`` or the global batch over its
    data-parallel ranks),
    the depth probes at it and their totals at ``cfg.n_layers``; saved
    to ``out_dir`` (default ``ARTIFACT_DIR``) unless ``save`` is
    False."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    search = None
    if mesh is not None:
        batch, microbatches = _mesh_batch(arch, cfg, shape, mesh,
                                          microbatches, batch)
        prb = probe_cell(arch, shape_name, cfg, batch, microbatches, mesh)
    elif batch is None:
        batch, prb, search = _choose_batch(arch, shape_name, cfg,
                                           microbatches)
    else:
        prb = probe_cell(arch, shape_name, cfg, batch, microbatches)
    cards = (mesh.size() if mesh is not None
             else shape.global_batch / batch)
    art = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "n_layers": cfg.n_layers, "batch": batch,
           "global_batch": shape.global_batch,
           "cards": cards, "probe": prb,
           "batch_search": search, "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if mesh is not None:
        plan = mesh_plan(cfg, mesh)
        art["mesh"] = dict(zip(mesh.mesh_dim_names,
                               (int(n) for n in mesh.shape)))
        art["n_devices"] = int(mesh.size())
        art["head_split"] = plan.heads
        art["experts_split"] = plan.experts
        art["ssm_split"] = plan.ssm
        art["rows_split"] = plan.rows
    if shape.kind == "train":
        art["microbatches"] = train_config(arch, batch,
                                           microbatches).microbatches
    tot = corrected_totals(art, prb)
    art["counts"] = {k: v for k, v in tot.items()
                     if k != "corrected" and not k.startswith("coll.")}
    if mesh is not None:
        art["collective_bytes"] = {k[5:]: v for k, v in tot.items()
                                   if k.startswith("coll.")}
    art["fits"] = tot["peak_bytes"] <= HBM_BYTES
    art["seconds"] = time.time() - t0
    flops = sum(v for k, v in tot.items() if k.startswith("flops_"))
    coll = art.get("collective_bytes", {}).get("total", 0.0)
    where = (f" mesh {mesh_tag(mesh)} (heads "
             f"{'split' if art['head_split'] else 'replicated'}, experts "
             f"{'split' if art['experts_split'] else 'replicated'}, "
             f"d_inner {'split' if art['ssm_split'] else 'replicated'}"
             f"{', Mamba rows split' if art['rows_split'] else ''} "
             "over model)" if mesh is not None else "")
    print(f"[dryrun] {arch} {shape_name}{where}: batch {batch} a card "
          f"({art['cards']:g} cards), {flops / 1e9:.1f} GFLOP, "
          f"{tot['bytes'] / 1e9:.1f} GB accessed, args "
          f"{tot['argument_bytes'] / 1e9:.2f} GB, peak "
          f"{tot['peak_bytes'] / 1e9:.2f} GB (fits 80 GB: {art['fits']}), "
          f"collectives {coll / 1e9:.2f} GB; {art['seconds']:.1f} s")
    if save:
        out_dir = out_dir or ARTIFACT_DIR
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape_name}"
        if mesh is not None:
            name += f"__{mesh_tag(mesh)}"
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(art, f, indent=1)
    return art


def parse_mesh(spec: str):
    """``"16x16:data,model"`` -> ((16, 16), ("data", "model"))."""
    shape_s, axes_s = spec.split(":")
    return (tuple(int(x) for x in shape_s.split("x")),
            tuple(axes_s.split(",")))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="shape name (default: all applicable)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a card (default: the largest that fits)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut (default: the config's depth)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="training microbatches (default: "
                    "TRAIN_MICROBATCHES)")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '16x16:data,model': one rank of that mesh, "
                    "under a fake process group")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) pod,data,model mesh")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh or args.multi_pod:
        from repro_torch.launch.mesh import make_mesh_shape

        shape, axes = (parse_mesh(args.mesh) if args.mesh else
                       ((2, 16, 16), ("pod", "data", "model")))
        mesh = make_mesh_shape(shape, axes, "meta", fake=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    failures = []
    for arch in archs:
        shapes = ([args.shape] if args.shape
                  else list(applicable_shapes(get_config(arch))))
        for shape in shapes:
            cfg = get_config(arch)
            if args.layers:
                cfg = probe_config(cfg, args.layers)
            try:
                dryrun_cell(arch, shape, batch=args.batch, cfg=cfg,
                            microbatches=args.microbatches,
                            out_dir=args.out_dir, mesh=mesh)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                traceback.print_exc()
                if not args.continue_on_error:
                    raise
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells counted.")


if __name__ == "__main__":
    main()
