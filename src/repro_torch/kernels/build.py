"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles, with its headers, into its own shared
library with a plain C entry point, for ``sm_90a``, at first use.  The
libraries land in ``build/repro_torch/`` at the root of the checkout,
named by a hash of their sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  ``build_all`` starts one
``nvcc`` per source in parallel.  The contract checker's broken fixture
kernels (``analysis/csrc/fixtures.cu``) build the same way, beside the
serving kernels (``EXTRA_SOURCES``).  Nothing here includes PyTorch's
headers: a plain C interface builds in seconds where a PyTorch extension
takes minutes.

Nothing in this module runs at import: the CPU tests import every
module, and there is no ``nvcc`` without a card.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "EXTRA_SOURCES", "NVCC_FLAGS", "build_all", "load",
           "function", "build_dir", "source_path", "load_counts", "NFParams",
           "NF_MAX_LAYERS", "NF_MAX_W"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("nf_forward", "fused_lookup", "range_scan", "streamed_lookup",
           "index_probe", "mamba_scan", "flash_decode")
# sources outside csrc/: the contract checker's broken fixture kernels
EXTRA_SOURCES = {"fixtures": CSRC.parents[1] / "analysis" / "csrc"
                 / "fixtures.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# must match nf_device.cuh
NF_MAX_LAYERS = 8
NF_MAX_W = 768


class NFParams(ctypes.Structure):
    """Kernel-argument copy of the packed flow weights (nf_device.cuh)."""

    _fields_ = [("dim", ctypes.c_int), ("n_layers", ctypes.c_int),
                ("n_out", ctypes.c_int * NF_MAX_LAYERS),
                ("n_in", ctypes.c_int * NF_MAX_LAYERS),
                ("n_w", ctypes.c_int),
                ("w", ctypes.c_float * NF_MAX_W)]


_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}
# libraries compiled and loaded by this process, per source (the
# checker's alloc-budget contract holds each to at most one)
_COUNTS = {"built": collections.Counter(), "loaded": collections.Counter()}


def build_dir() -> Path:
    """``build/repro_torch/`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_path(name: str) -> Path:
    """The ``.cu`` file of library ``name``."""
    return EXTRA_SOURCES.get(name, CSRC / f"{name}.cu")


def _lib_path(name: str) -> Path:
    src = source_path(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _built(path: Path) -> bool:
    """A library counts as built only with its ptxas log beside it: one
    left without (a build from before the logs were kept) is built
    again, so every library has its log."""
    return path.exists() and path.with_suffix(".log").exists()


def load_counts() -> Dict[str, Dict[str, int]]:
    """Libraries this process compiled (``built``) and loaded
    (``loaded``), per source."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def build_all() -> Dict[str, dict]:
    """Compile every missing library (the serving kernels and the
    checker's fixtures), one ``nvcc`` per source, all at once.  Returns
    ``{name: {"path", "seconds", "built", "log"}}`` (the log carries
    ``-Xptxas -v``'s registers, shared memory and spills; it is kept
    beside the library, so a library built earlier returns its log too,
    and a library without its log is built again).
    Raises ``RuntimeError`` with the compiler's output if any build
    fails."""
    out: Dict[str, dict] = {}
    procs = {}
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for name in (*SOURCES, *EXTRA_SOURCES):
        path = _lib_path(name)
        if _built(path):
            out[name] = {"path": str(path), "seconds": 0.0, "built": False,
                         "log": path.with_suffix(".log").read_text()}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
        _COUNTS["built"][name] += 1
        out[name] = {"path": str(path), "seconds": time.perf_counter() - t0,
                     "built": True, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not _built(path):
            build_all()
        lib = ctypes.CDLL(str(path))
        _COUNTS["loaded"][name] += 1
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """C entry point ``symbol`` of kernel library ``name``, bound once:
    later calls return the same ctypes function without touching its
    ``argtypes``."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
