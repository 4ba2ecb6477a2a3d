"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and becomes one shared
library under ``build/`` at the repository root, compiled on first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -split-compile=0 -o build/<name>-<hash>.so \
         csrc/<name>.cu

(``-split-compile=0`` lets nvcc optimize a file's kernels on every core:
``fused_factor.cu``, one kernel per model width and type, took 69 s alone
and 41 s with it on the H100 machine.)

The file name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is rebuilt.
``build_all()`` starts one nvcc per source, all at once, and waits for them.
Nothing here runs at import time: the CPU tests import this module too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
SOURCES = ("kkt", "fused_factor", "disc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-split-compile=0", "-Xptxas",
              "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD / f"{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = open(BUILD / f"{name}.log", "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, log = job
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        text = (BUILD / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{text}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every missing library, one nvcc per source, in parallel."""
    jobs = {name: _start(name) for name in SOURCES}
    errors = []
    for name, job in jobs.items():
        try:
            _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return _LIBS[name]


def declare(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int):
    """Declare ``int fn(void* x n_ptr, int x n_int, void* stream)``."""
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def suffix(name: str, *ts: torch.Tensor) -> str:
    """The entry-point suffix for the tensors' dtype ("f32"/"f64"); raises
    unless every tensor is a CUDA tensor of one device and one such dtype."""
    dev, dtype = ts[0].device, ts[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain version CPU tensors")
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32/float64)")
    for t in ts:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: mixed devices or dtypes")
    return _SUFFIX[dtype]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
