"""Build the port's CUDA sources into shared libraries and load them.

Every kernel is a ``csrc/<name>.cu`` with a plain C interface (sources may
include the shared ``csrc/*.cuh`` headers).  ``nvcc`` compiles it for
``sm_90a`` into ``build/<name>-<hash>.so`` at the repository root, where
the hash covers the source, the headers and the flags, so an edited
source, header or flag never loads a stale library.  ``compile_all``
starts one ``nvcc`` per missing library, all at once, and waits for
them; ``load`` compiles what is missing, opens the library with
``ctypes`` and declares its C functions' signatures.
Nothing is built while a module is imported: the first CUDA call of a
kernel's wrapper builds it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what each kernel's build printed: name -> {"seconds", "ptxas", "path"}
info: dict[str, dict] = {}
_libs: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One CUDA source, ``csrc/<name>.cu``, and the C functions it exports
    as ``(name, argtypes, restype)``."""

    name: str
    functions: tuple = ()

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def compile_all(*kernels: Kernel) -> None:
    """Build every kernel whose library is missing, one ``nvcc`` each,
    all started together; record each build in ``info``."""
    jobs = []
    for kernel in kernels:
        out = kernel.library()
        if out.exists():
            info.setdefault(kernel.name, {"seconds": 0.0,
                                          "ptxas": "(cached build)",
                                          "path": str(out)})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(kernel.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((kernel, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for kernel, out, tmp, cmd, proc, t0 in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        info[kernel.name] = {"seconds": time.perf_counter() - t0,
                             "ptxas": log, "path": str(out)}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(kernel: Kernel) -> ctypes.CDLL:
    """The kernel's library, built first if it is missing."""
    if kernel.name not in _libs:
        compile_all(kernel)
        lib = ctypes.CDLL(str(kernel.library()))
        for fname, argtypes, restype in kernel.functions:
            fn = getattr(lib, fname)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _libs[kernel.name] = lib
    return _libs[kernel.name]
