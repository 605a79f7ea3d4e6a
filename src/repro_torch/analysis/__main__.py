"""``python -m repro_torch.analysis`` — the port's kernel-contract checker
(DESIGN.md §15).

Exit status is 0 iff no *blocking* finding survives the allowlist.

Flags:
  --contracts C[,C..]  subset of {host-sync,alloc,smem,lint} (default:
                       all)
  --allowlist PATH     reviewed-violation patterns (default: allow.txt
                       beside this module)
  --json               machine-readable report on stdout
  --fixtures           run over the deliberately broken fixtures
                       instead of the real entries (self-test: exits
                       nonzero iff a fixture that ran was NOT caught)
  --device cpu         run what the CPU can check, without a card; the
                       checks that need the card are named, not run

Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Optional

DEFAULT_ALLOWLIST = str(Path(__file__).resolve().with_name("allow.txt"))
CONTRACTS = ("host-sync", "alloc", "smem", "lint")
# the checks each contract runs only on the card
CARD_ONLY = {
    "host-sync": ("host-sync: the sync debug mode against the recorder",),
    "lint": ("lint: PTX lints of every source (nvcc -ptx)",
             "lint:spill: the build's ptxas log",
             "lint:batch-loop: the profiler's launch facts"),
    "smem": ("smem: static bytes against the ptxas log",
             "smem: the model against the profiler's launches",
             "smem: the limit read from the card"),
}


def _group(contract: str) -> str:
    head = contract.split(":", 1)[0]
    return {"alloc-budget": "alloc"}.get(head, head)


def _merge(report, scratch, wanted) -> None:
    for f in scratch.findings:
        if _group(f.contract) in wanted:
            report.add(f)
    for entry, contract in scratch.checked:
        if _group(contract) in wanted:
            report.note_pass(entry, contract)


def run_all(report, device, wanted=CONTRACTS) -> dict:
    """Every wanted contract on ``device``; returns the facts the run
    measured (host syncs per entry, launches, shared memory, allocation
    counts) and the checks that need the card and were not run."""
    import torch

    from repro_torch.analysis import alloc, contracts, ptx_checks, smem
    from repro_torch.analysis.findings import Report

    device = torch.device(device)
    on_card = device.type == "cuda"
    facts: dict = {"device": str(device), "not_run": []}
    if not on_card:
        for c in wanted:
            facts["not_run"] += list(CARD_ONLY.get(c, ()))
    limit = smem.SMEM_LIMIT
    if on_card:
        limit = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
        facts["smem_limit"] = limit

    if "host-sync" in wanted or (on_card and {"lint", "smem"} & set(wanted)):
        scratch = Report()
        params = smem.launch_params() if on_card else contextlib.nullcontext()
        with params as rec:
            out = contracts.run_host_sync_checks(scratch, device)
            if on_card:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    smem.calibration_launches(device)
                cal = contracts.parse_launch_facts(
                    contracts.trace_events(prof), set(smem.STATIC))
        _merge(report, scratch, wanted)
        facts["syncs"] = out["syncs"]
        facts["launches"] = out["launches"]
        if on_card and "smem" in wanted:
            paired = rec.pair(out["launches"] + cal, limit)
            smem.check_launches(report, paired)
            facts["smem_launches"] = paired
    if "alloc" in wanted:
        facts["alloc"] = alloc.run_alloc_checks(report, device=device)
    if "smem" in wanted:
        facts["smem_grid"] = smem.run_smem_checks(report, limit=limit)
    if on_card and {"lint", "smem"} & set(wanted):
        from repro_torch.kernels import build

        info = build.build_all()
        logs = {n: r["log"] for n, r in info.items() if r["log"]}
        if "smem" in wanted:
            facts["smem_static"] = smem.check_static_against_ptxas(
                report, logs, expect=smem.STATIC)
        if "lint" in wanted:
            lines = contracts.kernel_lines()
            for log in logs.values():
                ptx_checks.check_ptxas_log(log, report, lines)
            facts["ptx"] = ptx_checks.check_sources(report, build.SOURCES)
    return facts


def _render_facts(facts: dict) -> str:
    lines = []
    for name, st in sorted(facts.get("syncs", {}).items()):
        dbg = (st["debug_syncs"] if facts["device"].startswith("cuda")
               else "not run")
        lines.append(f"  syncs  {name}: {st['calls']} calls, recorder "
                     f"{st['syncs']}, debug mode {dbg}, most in one call "
                     f"{st['max_per_call']} (budget {st['budget']})")
    for f in facts.get("launches", []):
        lines.append(f"  launch {f['kernel']} grid {f['grid']} block "
                     f"{f['block']} smem {f['smem']} regs {f['regs']} "
                     f"<- {f.get('entry', f['call'])}")
    for f in facts.get("smem_launches", []):
        lines.append(f"  smem   {f['kernel']} {f['params']}: model "
                     f"{f['model']}, measured {f['smem']}")
    for r in facts.get("smem_static", []):
        lines.append(f"  smem   {r['symbol']}: ptxas {r['ptxas']} static, "
                     f"model {r['model']}")
    for what in facts.get("not_run", []):
        lines.append(f"  not run (needs the card): {what}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Kernel-contract checks of the port's serving path")
    ap.add_argument("--contracts", default=",".join(CONTRACTS),
                    help="comma list of " + ",".join(CONTRACTS))
    ap.add_argument("--allowlist", default=None)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--fixtures", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu: run without a card (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.findings import Report, load_allowlist
    from repro_torch.kernels.backend import resolve_device

    device = resolve_device(args.device)
    if args.fixtures:
        return run_fixture_selftest(device, as_json=args.json)
    wanted = tuple(c.strip() for c in args.contracts.split(",") if c.strip())
    unknown = set(wanted) - set(CONTRACTS)
    if unknown:
        print(f"unknown contracts: {sorted(unknown)}", file=sys.stderr)
        return 2
    report = Report(allowlist=load_allowlist(args.allowlist
                                             or DEFAULT_ALLOWLIST))
    facts = run_all(report, device, wanted)
    if args.json:
        payload = json.loads(report.to_json())
        payload["facts"] = facts
        print(json.dumps(payload, indent=2, default=str))
    else:
        text = _render_facts(facts)
        print((text + "\n" if text else "") + report.render())
    return 0 if report.ok else 1


def run_fixture_selftest(device, as_json: bool = False) -> int:
    """Every broken fixture must produce a blocking finding of its own
    contract with a location — the checker checking itself.  On the CPU
    the kernel fixtures are named and not run."""
    import torch

    from repro_torch.analysis.findings import Report
    from repro_torch.analysis.fixtures import FIXTURES

    device = torch.device(device)
    on_card = device.type == "cuda"
    ptx_text = None
    if on_card:
        from repro_torch.utils.ptx import compile_ptx

        ptx_text = compile_ptx("fixtures").read_text()
    results, missed = {}, []
    for name, fixture in FIXTURES.items():
        if fixture.needs_card and not on_card:
            results[name] = {"status": "not run (needs the card)"}
            continue
        rep = Report()
        fixture.run(rep, device, ptx_text=ptx_text)
        caught = sorted((f for f in rep.blocking()
                         if f.contract == fixture.check
                         and f.location not in ("", "-")),
                        key=lambda f: "fixtures." not in f.location)
        where = caught[0].key().rsplit(" ", 1)[-1] if caught else "-"
        results[name] = {"status": "caught" if caught else "MISSED",
                         "location": where,
                         "findings": [f.key() for f in caught]}
        if not caught:
            missed.append(name)
    if as_json:
        print(json.dumps({"ok": not missed, "fixtures": results}, indent=2))
    else:
        for name, r in results.items():
            print(f"  {r['status']}  {name}"
                  + (f"  @ {r['location']}" if "location" in r else ""))
        ran = sum("location" in r for r in results.values())
        print(f"FAIL: fixtures not caught: {missed}" if missed
              else f"OK: all {ran} broken fixtures that ran were caught")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
