"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

The counterpart of the JAX package's ``kernels/compat.py``: where that shim
papers over Pallas API drift, this module turns ``csrc/<name>.cu`` into
``build/kernels/<name>-<digest>.so`` at the root of the checkout (listed in
``.gitignore``) with one ``nvcc`` per source, all started together, for
``sm_90a`` (Hopper).  Each library exports plain C entry points that launch
on the stream they are given and return ``cudaGetLastError()``; the
wrappers pass that code to :func:`check`.  A failed build raises: there is
no fallback.  The digest covers the sources and the flags, so an edited
kernel is rebuilt and a current one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("systolic_matmul", "vector_engine", "flash_attention", "lindley")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin/ on PATH)")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel source whose library is missing, in parallel.

    Returns the compiler's output (ptxas register and shared-memory
    counts) by source name, for the sources built by this call.
    """
    with _LOCK:
        todo = {n: path for n in SOURCES
                if not (path := library_path(n)).exists()}
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = {}, []
        for name, (tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, todo[name])
            else:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def dtype_code(dtype: torch.dtype) -> int:
    """The element-type code of ``csrc/common.cuh`` (fp32 0, bf16 1)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]


def require_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on a CUDA device and is contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} runs on a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} takes contiguous tensors")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a ``c_void_p`` int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}: {msg})")
