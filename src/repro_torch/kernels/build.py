"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file under ``kernels/`` has a plain C interface and is
compiled on first use into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), for ``sm_90a`` (Hopper).  The library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing is built when a
module is imported: the first kernel launch, or :func:`build_all`, does it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Dict, Optional

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"

#: library name → its source, relative to ``kernels/``
SOURCES = {"maxplus": "maxplus/csrc/maxplus.cu",
           "sparse_levels": "maxplus/csrc/sparse_levels.cu",
           "dense_levels": "maxplus/csrc/dense_levels.cu",
           "flash_attention": "flash_attention/csrc/flash_attention.cu",
           "flash_prefill": "flash_attention/csrc/flash_prefill.cu",
           "flash_decode": "flash_attention/csrc/flash_decode.cu",
           "linear_scan": "linear_scan/csrc/linear_scan.cu",
           "mamba_scan": "linear_scan/csrc/mamba_scan.cu",
           "tree_precond": "ipm/csrc/tree_precond.cu",
           "wkv6": "rwkv/csrc/wkv6.cu"}

#: library name → the file this process loaded it from, in load order: the
#: "programs" :class:`repro_torch.obs.CompileWatcher` counts
LOADED: Dict[str, pathlib.Path] = {}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuiltLibrary:
    name: str
    path: pathlib.Path
    seconds: float            # nvcc wall time (0.0 when the library was cached)
    ptxas: Dict[str, dict]    # kernel → registers, smem_bytes, spill_stores/loads


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                           "the CUDA kernels are built from source on first use")
    return found


def _lib_path(name: str, flags=()) -> pathlib.Path:
    src = (KERNELS_DIR / SOURCES[name]).read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS + tuple(flags)).encode()
                       ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def parse_ptxas(log: str) -> Dict[str, dict]:
    """Registers, shared memory and spills per kernel from ``-Xptxas -v``."""
    out: Dict[str, dict] = {}
    current: Optional[str] = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[current]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def build_all(names=None, variants=None) -> Dict[str, BuiltLibrary]:
    """Compile every (or the named) library that is not built yet, with one
    ``nvcc`` per source, all started together.  ``variants`` maps a label
    to (library name, extra nvcc flags): builds of a source with the
    compile-time knobs its header names, for measurement, started with the
    rest and returned under their labels.  Raises on a failed build."""
    jobs = {name: (name, ()) for name in
            (SOURCES if names is None else names)}
    jobs.update(variants or {})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    built: Dict[str, BuiltLibrary] = {}
    for name, (lib, flags) in jobs.items():
        path = _lib_path(lib, flags)
        if path.is_file():                # ptxas's report from its build
            log = path.with_suffix(".log")
            built[name] = BuiltLibrary(name, path, 0.0, parse_ptxas(
                log.read_text()) if log.is_file() else {})
            continue
        nvcc = nvcc or find_nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(KERNELS_DIR / SOURCES[lib])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, path)
    done = {}
    for name, (proc, t0, tmp, path) in procs.items():   # reap every nvcc
        log, _ = proc.communicate()
        done[name] = (proc.returncode, log, time.perf_counter() - t0)
    for name, (proc, t0, tmp, path) in procs.items():
        rc, log, seconds = done[name]
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[jobs[name][0]]} "
                               f"{' '.join(jobs[name][1])} (exit {rc}):"
                               f"\n{log}")
        tmp.with_suffix(".log").write_text(log)
        os.replace(tmp.with_suffix(".log"), path.with_suffix(".log"))
        os.replace(tmp, path)           # atomic: concurrent builders agree
        built[name] = BuiltLibrary(name, path, seconds, parse_ptxas(log))
    return built


def load(name: str) -> ctypes.CDLL:
    """Load the library ``name``, building it first if needed, and record it
    in :data:`LOADED`."""
    path = build_all([name])[name].path
    lib = ctypes.CDLL(str(path))
    LOADED.setdefault(name, path)
    return lib
