"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one source `regennet_torch/csrc/<name>.cu` with a
plain C interface (it may include headers `csrc/*.cuh`). At first use it
is compiled by nvcc for Hopper (`sm_90a`) into a shared library under
`regennet_torch/build/` (named by a hash of the source and the headers it
includes, so an edit to either is rebuilt) and loaded with ctypes, its
functions typed from a table of prototypes. Nothing here runs at import
time; the CPU tests import this module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"

# every kernel source of the port, by name
KERNELS = ("attention_fwd", "attention_btd_train")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources(name: str) -> List[Path]:
    """The source of kernel library `name` and the local headers it
    includes (`#include "x.cuh"`, followed through headers)."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for header in re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(), re.M):
            if CSRC / header not in found:
                found.append(CSRC / header)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    return BUILD / f"{name}-{digest.hexdigest()[:16]}.so"


def build_kernels(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns {name: {"seconds", "log"}}
    (seconds 0.0 and an empty log for a library that was already built).
    Raises RuntimeError with nvcc's output if a build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    done = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            done[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


Prototype = Tuple[type, Sequence[type]]  # (restype, argtypes) in ctypes types


def load_library(name: str, prototypes: Mapping[str, Prototype]) -> ctypes.CDLL:
    """The built kernel library with its C functions typed from
    `prototypes`, compiling it first if needed."""
    build_kernels([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (restype, argtypes) in prototypes.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib
