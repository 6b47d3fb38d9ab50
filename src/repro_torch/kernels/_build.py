"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. Pointers and the stream
pass as ``c_void_p``; every C entry returns ``cudaGetLastError()`` right
after its launch, and :func:`check` raises when that is not 0.

Libraries land in ``build/repro_torch_kernels/<hash>/`` under the checkout,
where the hash covers every source, header and flag, so an edited kernel is
rebuilt and a stale library is never loaded. They are built at first use:
one ``nvcc`` process per source, all started together. Nothing here runs at
import time; this module imports on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("quantize", "fq_matmul", "fq_conv", "lm_island")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    h = hashlib.blake2s(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def build_all() -> Path:
    """Compile every missing library in parallel; return the build dir.

    A library is written under a temporary name and renamed into place, so
    a reader never sees a half-written file. ``nvcc``'s output (the
    ``-Xptxas -v`` register and shared-memory report) is kept beside each
    library as ``<name>.log``.
    """
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = out / f".lib{n}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        (out / f"{n}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (rc {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out / f"lib{n}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built on first use, with
    ``argtypes`` set from ``signatures``; each of those entries returns a
    ``cudaError_t`` as an int, which ``fq_error_string`` names."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.fq_error_string.argtypes = [ctypes.c_int]
        lib.fq_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(err: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.fq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


_SMS: Dict[int, int] = {}


def sm_count(device) -> int:
    """The CUDA device's multiprocessor count, read once per device."""
    import torch
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n
