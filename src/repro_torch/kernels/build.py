"""Build the hand-written CUDA kernels and load them with ctypes.

Each source in ``csrc/`` has a plain C interface and is compiled by
``nvcc`` on its own, with the ``csrc/`` headers it includes, into a
shared library under ``build/kernels/`` at the root of the checkout
(``.gitignore`` lists ``build/``). A library's file name carries a hash
of its source, the headers and the flags, so an edited source or header
is rebuilt and an unchanged one is loaded as it is. Every C entry point
returns ``cudaGetLastError()`` after its launches; :func:`check` turns a
non-zero code into an exception.

Nothing is built when this module is imported: :func:`library` builds on
first use, and :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("plane_or", "plane_extract", "dequant_matmul", "dequant_matmul_mma",
           "decode_attention", "verify_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of each library: {name: argtypes}; every one returns int.
SIGNATURES = {
    "plane_or": {"plane_or_segments": [P, P, P, P, I64, I32, I32, P],
                 "plane_or": [P, P, P, I64, I32, I32, I32, P]},
    "plane_extract": {"plane_extract": [P, P, I64, I32, I32, I32, I32, I32, P]},
    "dequant_matmul": {"dequant_matmul": [P, I32, P, I32, I64, I64, P, P, P, P, I32, I32,
                                          I32, I32, P]},
    "dequant_matmul_mma": {"dequant_matmul_mma": [P, I32, P, I32, I64, I64, P, P, P, I32, I32,
                                                  I32, I32, P]},
    "decode_attention": {"flash_decode": [P, P, P, P, I64, I64, P, P, I32, I32, I32, I32,
                                          I32, I32, F32, F32, I32, P]},
    "verify_attention": {"flash_verify": [P, I64, I64, P, P, P, I64, I64, P, I64, I64, P,
                                          I32, I32, I32, I32, I32, I32, I32, F32, F32,
                                          I32, P]},
}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


def _target(name: str) -> Path:
    # the source and every header of csrc/ (a header edit rebuilds its users)
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _compile(name: str) -> tuple | None:
    """Start ``nvcc`` for one source unless its library is built already.
    Returns (process, temporary output, final output, command) or None."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, cmd


def _finish(job: tuple) -> None:
    proc, tmp, out, cmd = job
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source that has no library yet, all at once."""
    jobs = [j for j in (_compile(n) for n in SOURCES) if j is not None]
    for j in jobs:
        _finish(j)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _compile(name)
        if job is not None:
            _finish(job)
        lib = ctypes.CDLL(str(_target(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
