"""PTX and ptxas analysis of the port's CUDA sources (DESIGN.md §15).

The counterpart of ``repro.utils.hlo``, which reads XLA's lowered text:
the port's kernels are CUDA C++, so what the contract checker reads is
the PTX that ``nvcc`` emits for them and the ``-Xptxas -v`` log of the
build.

* ``compile_ptx`` compiles a source to PTX with the build's ``-gencode``
  and ``-std`` plus ``-ptx -lineinfo`` (a separate compile: the serving
  libraries are untouched), into ``build/repro_torch/ptx/``;
* ``parse_ptx`` splits PTX into its functions and instructions, each
  instruction with the ``file.cu:line`` its ``.loc`` names;
* ``parse_ptxas_log`` reads registers, static shared memory, stack and
  spill bytes per function from ``build.build_all()``'s logs;
* ``op_census`` and ``f64_census`` count opcodes and f64 instructions,
  as ``hlo.op_census`` and ``hlo.f64_census`` do for HLO.

Nothing here runs at import; only ``compile_ptx`` needs ``nvcc``.
"""

from __future__ import annotations

import collections
import re
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["Instr", "Function", "compile_ptx", "compile_all_ptx",
           "normalize_ptx", "parse_ptx", "parse_ptxas_log",
           "kernel_base_name", "global_lines", "op_census", "f64_census"]

PTX_FLAGS = ("-ptx", "-lineinfo")

_LOC_RE = re.compile(r"^\s*\.loc\s+(\d+)\s+(\d+)\s+(\d+)"
                     r"(?:.*inlined_at\s+(\d+)\s+(\d+)\s+(\d+))?")
_FILE_RE = re.compile(r'^\s*\.file\s+(\d+)\s+"([^"]*)"')
_FUNC_RE = re.compile(r"\.(entry|func)\s+(?:\([^)]*\)\s*)?([\w$]+)")
_PRED_RE = re.compile(r"^@!?%\w+\s+")


class Instr(NamedTuple):
    """One PTX instruction: ``opcode`` with its modifiers
    (``ld.global.nc.f32``), operands as written, and the source line its
    ``.loc`` names (``fixtures.cu:30``; ``"-"`` before any ``.loc``)."""

    opcode: str
    operands: Tuple[str, ...]
    loc: str


class Function(NamedTuple):
    name: str          # the mangled symbol
    kind: str          # "entry" (a kernel) or "func"
    instrs: List[Instr]


def _gencode_and_std() -> List[str]:
    from repro_torch.kernels.build import NVCC_FLAGS

    out, flags = [], list(NVCC_FLAGS)
    for i, f in enumerate(flags):
        if f == "-gencode":
            out += flags[i:i + 2]
        elif f.startswith("-std"):
            out.append(f)
    return out


def ptx_dir() -> Path:
    from repro_torch.kernels.build import build_dir

    return build_dir() / "ptx"


def compile_ptx(name: str) -> Path:
    """PTX of library ``name`` (a ``build.SOURCES`` or ``EXTRA_SOURCES``
    name), compiled now into ``build/repro_torch/ptx/<name>.ptx``.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    return compile_all_ptx([name])[name]


def compile_all_ptx(names: Sequence[str]) -> Dict[str, Path]:
    """``compile_ptx`` for several sources, one ``nvcc`` each, all at
    once."""
    from repro_torch.kernels.build import _nvcc, source_path

    ptx_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = ptx_dir() / f"{name}.ptx"
        cmd = [_nvcc(), *_gencode_and_std(), *PTX_FLAGS, "-o", str(out),
               str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    failures, paths = [], {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc -ptx failed for {name}:\n{log}")
        paths[name] = out
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def normalize_ptx(text: str) -> str:
    """PTX without its header comments (compiler build and release) and
    with every ``.file`` path cut to its basename, so two checkouts'
    PTX of one source compare equal."""
    out = []
    for line in text.splitlines():
        if line.startswith("//") and not out:
            continue
        m = _FILE_RE.match(line)
        if m:
            line = f'\t.file\t{m.group(1)} "{Path(m.group(2)).name}"'
        out.append(line)
    while out and not out[0].strip():
        out.pop(0)
    return "\n".join(out) + "\n"


def _split_operands(text: str) -> Tuple[str, ...]:
    """Operands split at top-level commas (not inside ``[]`` or ``{}``)."""
    ops, depth, cur = [], 0, []
    for ch in text:
        if ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        if ch == "," and depth == 0:
            ops.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        ops.append("".join(cur).strip())
    return tuple(ops)


def parse_ptx(text: str) -> List[Function]:
    """The functions of a PTX module with their instructions in order,
    each instruction carrying the ``basename:line`` of the last ``.loc``
    before it (``.file`` maps the file numbers; the directives may come
    after the code).  A ``.loc`` inside a toolkit header (``.h``,
    ``.hpp``: an intrinsic such as ``__ldg``) names its ``inlined_at``
    call site instead, and line 0 (code the compiler made up) keeps the
    line before it."""
    files: Dict[str, str] = {}
    for line in text.splitlines():
        m = _FILE_RE.match(line)
        if m:
            files[m.group(1)] = Path(m.group(2)).name
    funcs: List[Function] = []
    cur: Optional[Function] = None
    depth = 0
    loc = ("", 0)
    for raw in text.splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        if cur is None:
            m = _FUNC_RE.search(line)
            if m and not line.endswith(";"):
                cur, depth, loc = Function(m.group(2), m.group(1), []), 0, ("", 0)
            continue
        if depth == 0:
            if line.endswith(";"):          # a prototype: no body follows
                cur = None
            elif line.startswith("{"):
                depth = line.count("{") - line.count("}")
            continue
        m = _LOC_RE.match(line)
        if m:
            f, ln = m.group(1), int(m.group(2))
            if m.group(4) and files.get(f, "").endswith((".h", ".hpp")):
                f, ln = m.group(4), int(m.group(5))
            if ln:
                loc = (f, ln)
            continue
        depth += line.count("{") - line.count("}")
        if depth <= 0:
            funcs.append(cur)
            cur = None
            continue
        if line[0] in ".{}" or line.endswith(":"):
            continue
        body = _PRED_RE.sub("", line).rstrip(";").strip()
        parts = body.split(None, 1)
        where = f"{files.get(loc[0], loc[0])}:{loc[1]}" if loc[1] else "-"
        cur.instrs.append(Instr(parts[0], _split_operands(parts[1])
                                if len(parts) > 1 else (), where))
    return funcs


_LOG_FN_RE = re.compile(
    r"(?:Compiling entry function|Function properties for)\s+'?([\w$]+)'?")
_LOG_NUMS = {
    "registers": re.compile(r"Used (\d+) registers"),
    "smem": re.compile(r"(\d+) bytes smem"),
    "stack": re.compile(r"(\d+) bytes stack frame"),
    "spill_stores": re.compile(r"(\d+) bytes spill stores"),
    "spill_loads": re.compile(r"(\d+) bytes spill loads"),
}


def parse_ptxas_log(log: str) -> Dict[str, Dict[str, int]]:
    """``-Xptxas -v`` output -> ``{mangled function: {"registers",
    "smem" (static bytes), "stack", "spill_stores", "spill_loads"}}``
    (keys present where ptxas printed them)."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _LOG_FN_RE.search(line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, rx in _LOG_NUMS.items():
            hit = rx.search(line)
            if hit:
                out[name][key] = int(hit.group(1))
        if "Used" in line and "smem" not in line:
            out[name].setdefault("smem", 0)
    return out


def kernel_base_name(symbol: str) -> str:
    """A kernel's name without its mangling, template arguments or
    parameter list: ``_Z22streamed_lookup_kernelILi1EEv10StreamArgs8NFParams``
    and ``void streamed_lookup_kernel<1>(StreamArgs, NFParams)`` both give
    ``streamed_lookup_kernel``."""
    m = re.match(r"_Z(\d+)", symbol)
    if m:
        n = int(m.group(1))
        return symbol[m.end():m.end() + n]
    head = symbol.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else symbol


def global_lines(source: Path) -> Dict[str, str]:
    """``{kernel name: "file.cu:line" of its __global__}`` over a CUDA
    source and the headers beside it (the first definition of a name)."""
    out: Dict[str, str] = {}
    paths = [source] + sorted(source.parent.glob("*.cuh"))
    for path in paths:
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "__global__" not in line:
                continue
            head = " ".join(lines[i:i + 6]).split("__global__", 1)[1]
            m = re.search(r"(\w+)\s*\(", re.sub(r"__launch_bounds__\s*\([^)]*\)",
                                                 "", head))
            if m:
                out.setdefault(m.group(1), f"{path.name}:{i + 1}")
    return out


def op_census(ptx_text: str) -> Dict[str, int]:
    """Count opcodes (with their modifiers) over every function."""
    census: Dict[str, int] = collections.Counter()
    for fn in parse_ptx(ptx_text):
        for ins in fn.instrs:
            census[ins.opcode] += 1
    return dict(census)


def f64_census(ptx_text: str) -> int:
    """Count instructions that compute in or convert to or from f64 —
    the serving path is f32 by design (DESIGN.md §8)."""
    return sum(1 for fn in parse_ptx(ptx_text) for ins in fn.instrs
               if "f64" in ins.opcode.split("."))
