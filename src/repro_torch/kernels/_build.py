"""Build and load the port's CUDA kernels: one ``nvcc`` rule for all.

Each source ``csrc/<name>.cu`` is compiled for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside
this file, and loaded with ``ctypes``.  A library's file name carries a
hash of its source and the flags, so a changed source or flag set is
never served by an old library.  Nothing is compiled or loaded when a
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


class CudaLibrary:
    """One kernel source, its built library and its ``ctypes`` handle.

    ``signatures`` maps each exported C function to ``(argtypes,
    restype)``; every function is declared before first use.  Every
    source also exports ``<name>_error_string``, which ``check`` uses."""

    def __init__(self, name: str, signatures: dict) -> None:
        self.name = name
        self.source = CSRC / f"{name}.cu"
        tag = hashlib.sha256(self.source.read_bytes() +
                             "\0".join(NVCC_FLAGS).encode()).hexdigest()[:8]
        self.path = BUILD_DIR / f"lib{name}.{tag}.so"
        self.ptxas_report = BUILD_DIR / f"{name}.{tag}.ptxas.txt"
        self._signatures = {**signatures, f"{name}_error_string": (
            [ctypes.c_int], ctypes.c_char_p)}
        self._lib: Optional[ctypes.CDLL] = None

    def built(self) -> bool:
        return self.path.exists() and self.ptxas_report.exists()

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            build(self)
            lib = ctypes.CDLL(str(self.path))
            for fn, (argtypes, restype) in self._signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error (0 is success)."""
        if err:
            msg = getattr(self.load(), f"{self.name}_error_string")(err)
            raise RuntimeError(f"{what} launch failed: {msg.decode()} "
                               f"(cudaError {err})")


def build(*libraries: CudaLibrary) -> None:
    """Compile every library not built yet, one ``nvcc`` process each, all
    started together.  The compiler's per-kernel report (registers, shared
    memory, spills) is kept in each library's ``ptxas_report``."""
    todo = [lib for lib in libraries if not lib.built()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for lib in todo:
        tmp = lib.path.with_name(f"{lib.path.name}.{os.getpid()}.tmp")
        procs.append((lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(lib.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for lib, tmp, proc in procs:      # wait for every one, then report
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {lib.source.name}:\n{err}")
            continue
        lib.ptxas_report.write_text(err)
        os.replace(tmp, lib.path)   # atomic: no process loads a half-written file
    if failed:
        raise RuntimeError("\n".join(failed))

