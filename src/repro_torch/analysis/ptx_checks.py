"""PTX-level lints over the port's CUDA sources (DESIGN.md §15).

The counterpart of ``repro.analysis.jaxpr_checks``: where the JAX
checker walks a kernel body's jaxpr, this walks the PTX ``nvcc`` emits
for each source (``utils.ptx``), one function at a time.  PTX virtual
registers are close to SSA, so a def-use walk inside a function is
enough; every finding names the ``file.cu:line`` of the ``.loc`` it
sits under (entry: the kernel's name).

- ``lint:clamp-gather`` (B8's class): an integer ``min`` and ``max``
  (or the ``setp``/``selp`` pairs nvcc makes of ``x < lo ? lo : x``)
  whose result reaches the address of an ``ld.global``,
  ``ld.global.nc`` or ``ld.shared`` through integer address arithmetic
  (``cvt``, ``cvta``, ``mov``, ``add``, ``sub``, ``mul``, ``mad``,
  ``shl``, ``selp``).  On Hopper a clamp costs no vector width; what it
  costs is that an out-of-range index becomes a wrong but plausible
  read, which the §8 verify/shadow net must then catch.  So every
  clamped gather is a reviewed site: the real kernels' deliberate
  clamps stand in the allowlist with their reasons.  A clamp that only
  bounds a loop never reaches an address and passes.
- ``lint:lane-cast`` (B9's class), the two rules of
  ``jaxpr_checks.py:165-183``: a ``cvt`` from an unsigned integer to a
  float (f32 carries 24 mantissa bits; the u64 identity rides as two
  u32 lanes and must stay integral), or an unsigned narrowing ``cvt`` of
  a lane.  PTX writes every integer truncation as ``cvt.u32.u64``
  whatever the source's signedness (the compiler's own index and loop
  counter truncations too), so a narrowing counts only when its operand
  is a value loaded from memory (through moves), which is what an
  identity lane is.
- ``lint:f64``: any instruction that computes in, or converts to or from,
  f64 (a ``double`` literal in ``max(x, 1e-20)`` is the usual source):
  the serving path is f32 by design (DESIGN.md §8).
- ``lint:spill`` (``info``): a function that spills, from the ptxas log
  of the build.
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.analysis.findings import Finding, Report
from repro_torch.utils.ptx import (Function, kernel_base_name, parse_ptx,
                                   parse_ptxas_log)

__all__ = ["check_function", "check_ptx", "check_ptxas_log",
           "check_fixture_kernel", "check_sources"]

_REG = re.compile(r"%[a-z]+\d+")
_INT = re.compile(r"^[sub](8|16|32|64)$")
_UNSIGNED = re.compile(r"^u(8|16|32|64)$")
_FLOAT = re.compile(r"^(f16|bf16|f32|f64)(x2)?$")
# integer ops that carry an index into an address
_ADDR_OPS = frozenset({"cvt", "cvta", "mov", "add", "sub", "mul", "mad",
                       "shl", "selp"})
_LOADS = re.compile(r"^ld(u)?\.(global|shared)")
_LOAD_ANY = re.compile(r"^ldu?\.")


def _types(opcode: str) -> List[str]:
    return [p for p in opcode.split(".")[1:]
            if _INT.match(p) or _FLOAT.match(p) or p == "pred"]


def _regs(text: str) -> List[str]:
    return _REG.findall(text)


def _is_int_op(opcode: str) -> bool:
    types = _types(opcode)
    return bool(types) and all(_INT.match(t) for t in types)


def _defs(fn: Function) -> Dict[str, object]:
    """The (last) defining instruction of each register."""
    out = {}
    for ins in fn.instrs:
        if ins.operands:
            for r in _regs(ins.operands[0])[:1]:
                out[r] = ins
    return out


def _select_bound(ins, defs) -> Optional[Tuple[str, str]]:
    """A ``selp`` that bounds a value, as nvcc compiles ``x < lo ? lo :
    x`` and ``x > hi ? hi : x``: its predicate is an integer ``setp``
    comparing X with Y, one operand is X (or made from X in one step)
    and the other the bound (an immediate, Y, or Y plus an immediate).
    Returns (``"min"`` or ``"max"``, the X-side operand) or None."""
    if len(ins.operands) != 4:
        return None
    pdef = defs.get(ins.operands[3].lstrip("!"))
    if pdef is None or not pdef.opcode.startswith("setp."):
        return None
    parts = pdef.opcode.split(".")
    if len(parts) < 3 or parts[1] not in ("lt", "le", "gt", "ge", "lo",
                                          "ls", "hi", "hs") \
            or not _INT.match(parts[-1]) or len(pdef.operands) < 3:
        return None
    x, y = pdef.operands[1], pdef.operands[2]
    below = parts[1] in ("lt", "le", "lo", "ls")

    def x_side(op):
        if op == x:
            return True
        d = defs.get(op)
        return d is not None and x in d.operands[1:]

    def bound_side(op):
        if op == y or not op.startswith("%"):
            return True
        d = defs.get(op)
        return (d is not None and d.opcode.split(".")[0] in ("add", "sub")
                and y in d.operands[1:]
                and any(not o.startswith("%") for o in d.operands[1:]))

    a, b = ins.operands[1], ins.operands[2]
    if x_side(a) and bound_side(b):
        return ("min" if below else "max"), a
    if bound_side(a) and x_side(b):
        return ("max" if below else "min"), b
    return None


def _clamp_taint(fn: Function) -> Dict[str, Tuple[FrozenSet[str], str]]:
    """Per register, the clamp kinds (``min``/``max``, or a ``selp``
    bound that acts as one) reaching it through integer address
    arithmetic, and the location of the instruction that completed the
    clamp (flow-insensitive, to a fixed point, so loop-carried registers
    are covered)."""
    defs = _defs(fn)
    bounds = {}
    for ins in fn.instrs:
        if ins.opcode.startswith("selp.") and _is_int_op(ins.opcode):
            sb = _select_bound(ins, defs)
            if sb:
                bounds[id(ins)] = sb
    taint: Dict[str, Tuple[FrozenSet[str], str]] = {}
    for _ in range(16):
        changed = False
        for ins in fn.instrs:
            base = ins.opcode.split(".")[0]
            if not ins.operands or not _is_int_op(ins.opcode):
                continue
            if base not in _ADDR_OPS and base not in ("min", "max"):
                continue
            dst = _regs(ins.operands[0])
            if not dst:
                continue
            kind = base if base in ("min", "max") else None
            srcs = ins.operands[1:]
            if id(ins) in bounds:
                kind, xop = bounds[id(ins)]
                srcs = (xop,)
            elif base == "selp":
                srcs = ins.operands[1:3]
            kinds, origin = frozenset(), ""
            for op in srcs:
                for r in _regs(op):
                    if r in taint:
                        k, o = taint[r]
                        if len(k) == 2 and not origin:
                            origin = o
                        kinds |= k
            if kind:
                kinds |= {kind}
            if not kinds:
                continue
            if len(kinds) == 2 and not origin:
                origin = ins.loc
            old = taint.get(dst[0])
            new = (kinds | (old[0] if old else frozenset()),
                   (old[1] if old and old[1] else origin))
            if new != old:
                taint[dst[0]] = new
                changed = True
        if not changed:
            break
    return taint


def _loaded(fn: Function) -> set:
    """Registers that hold a value loaded from memory (through moves)."""
    out = set()
    for _ in range(8):
        n = len(out)
        for ins in fn.instrs:
            if not ins.operands:
                continue
            if _LOAD_ANY.match(ins.opcode) and ".param" not in ins.opcode:
                out.update(_regs(ins.operands[0]))
            elif ins.opcode.split(".")[0] == "mov" and any(
                    r in out for op in ins.operands[1:] for r in _regs(op)):
                out.update(_regs(ins.operands[0]))
        if len(out) == n:
            break
    return out


def check_function(fn: Function, report: Report,
                   entry: Optional[str] = None) -> List[Finding]:
    """Every PTX lint over one function; findings go into ``report`` and
    are returned."""
    entry = entry or kernel_base_name(fn.name)
    found: List[Finding] = []

    seen = set()

    def emit(contract, loc, message, **details):
        if (contract, loc) in seen:
            return
        seen.add((contract, loc))
        f = Finding(contract=contract, entry=entry, location=loc,
                    message=message, details=details)
        found.append(f)
        report.add(f)

    taint = _clamp_taint(fn)
    loaded = _loaded(fn)
    for ins in fn.instrs:
        parts = ins.opcode.split(".")
        if _LOADS.match(ins.opcode):
            addr = [op for op in ins.operands if "[" in op]
            for r in (_regs(addr[0]) if addr else []):
                if r in taint and len(taint[r][0]) == 2:
                    emit("lint:clamp-gather", taint[r][1],
                         "clamped gather: an index clamped here feeds "
                         f"`{ins.opcode}` (line {ins.loc}), so an "
                         "out-of-range index becomes a wrong but "
                         "plausible read (B8's class); review the clamp "
                         "and allowlist it with its reason",
                         load=ins.opcode, load_loc=ins.loc)
                    break
        if parts[0] == "cvt":
            types = _types(ins.opcode)
            if len(types) == 2:
                dst, src = types
                if _UNSIGNED.match(src) and _FLOAT.match(dst):
                    emit("lint:lane-cast", ins.loc,
                         f"unsigned lane cast to float: `{ins.opcode}` "
                         "(f32 carries 24 mantissa bits; the u64 "
                         "identity rides as two u32 lanes that must stay "
                         "integral)", src=src, dst=dst)
                elif (_UNSIGNED.match(src) and _INT.match(dst)
                      and int(dst[1:]) < int(src[1:])
                      and any(r in loaded for r in _regs(ins.operands[1]))):
                    emit("lint:lane-cast", ins.loc,
                         f"lane narrowing: `{ins.opcode}` drops the high "
                         "bits of a lane loaded from memory", src=src,
                         dst=dst)
        if "f64" in parts:
            emit("lint:f64", ins.loc,
                 f"f64 instruction: `{ins.opcode}` on an f32 path (the "
                 "kernels are f32 by design, DESIGN.md §8; a `double` "
                 "literal is the usual source)", opcode=ins.opcode)
    return found


def check_ptx(ptx_text: str, report: Report,
              kernels: Optional[set] = None) -> List[Finding]:
    """``check_function`` over every kernel (``.entry``) of a module, or
    over those whose base name is in ``kernels``; a clean kernel notes a
    ``lint`` pass."""
    found: List[Finding] = []
    for fn in parse_ptx(ptx_text):
        if fn.kind != "entry":
            continue
        name = kernel_base_name(fn.name)
        if kernels is not None and name not in kernels:
            continue
        hits = check_function(fn, report, name)
        if not hits:
            report.note_pass(name, "lint")
        found += hits
    return found


def check_ptxas_log(log: str, report: Report, source_lines: Dict[str, str]
                    ) -> Dict[str, Dict[str, int]]:
    """``lint:spill`` (info) for every function of a build log that
    spills, at its kernel's ``__global__`` line; returns the parsed
    log."""
    parsed = parse_ptxas_log(log)
    for sym, rec in parsed.items():
        spill = rec.get("spill_stores", 0) + rec.get("spill_loads", 0)
        if spill:
            name = kernel_base_name(sym)
            report.add(Finding(
                contract="lint:spill", entry=name,
                location=source_lines.get(name, "-"), severity="info",
                message=(f"{sym}: {rec.get('spill_stores', 0)} bytes of "
                         f"spill stores, {rec.get('spill_loads', 0)} of "
                         f"loads at {rec.get('registers')} registers"),
                details={"symbol": sym, **rec}))
    return parsed


def check_sources(report: Report, names) -> Dict[str, dict]:
    """Compile each named source to PTX (the build's flags plus ``-ptx
    -lineinfo``) and lint every kernel; returns ``{name: {"ptx": path,
    "kernels": n}}``.  Needs ``nvcc``."""
    from repro_torch.utils.ptx import compile_all_ptx

    out = {}
    for name, path in compile_all_ptx(list(names)).items():
        text = path.read_text()
        check_ptx(text, report)
        out[name] = {"ptx": str(path),
                     "kernels": sum(f.kind == "entry"
                                    for f in parse_ptx(text))}
    return out


def check_fixture_kernel(report: Report, fixture: str, kernel: str,
                         ptx_text: Optional[str] = None) -> List[Finding]:
    """The fixture's kernel of ``csrc/fixtures.cu`` through the lints
    (its PTX compiled now unless given), findings under the fixture's
    name."""
    if ptx_text is None:
        from repro_torch.utils.ptx import compile_ptx

        ptx_text = compile_ptx("fixtures").read_text()
    found: List[Finding] = []
    for fn in parse_ptx(ptx_text):
        if fn.kind == "entry" and kernel_base_name(fn.name) == kernel:
            found += check_function(fn, report, fixture)
    return found
