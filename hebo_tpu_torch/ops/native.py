"""Build and load the port's CUDA kernels (``hebo_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The build happens at
first use, into ``hebo_tpu_torch/build/`` (listed in ``.gitignore``), from
the sources in the checkout only; the library's file name carries a hash of
its source, so an edited source is rebuilt.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# exported C functions per source: name -> argtypes (restype is c_int, the
# cudaGetLastError() code)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "gram": {
        "hebo_matern32_gram": [_P, _P, _P, _F, _P, _I, _I, _I, _I, _P],
        "hebo_matern32_gram_rows": [_I, _I, _I],
        "hebo_matern32_gram_vjp": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "chol": {
        "hebo_chol_factor": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "hebo_chol_route": [_I],
        "hebo_chol_winv": [_P, _P, _P, _P, _P, _I, _I, _P],
        "hebo_chol_winv_route": [_I],
    },
    "ssk": {
        "hebo_ssk_cross": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hebo_ssk_self": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "hebo_ssk_route": [_I, _I, ctypes.c_longlong],
    },
    "pareto": {
        "hebo_nsga2_rank_crowd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "hebo_nsga2_fits": [_I, _I],
        "hebo_nsga2_route": [_I, _I],
        "hebo_nsga2_grid_scratch": [_I, _I],
        "hebo_nsga2_rank_crowd_grid": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P],
    },
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH): "
        "the CUDA kernels of hebo_tpu_torch are built from source at first use"
    )


def lib_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all in parallel
    (one ``nvcc`` per source), and keep each compiler output beside its
    library (``.log``).  Returns the compiler output per named source
    (ptxas' registers / shared memory / spills per kernel), this build's or
    the kept one; raises on a failed build."""
    names = list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {n: _log(n) for n in names}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode == 0:
            lib_path(n).with_suffix(".log").write_text(out)
            os.replace(tmp, lib_path(n))
        else:
            os.unlink(tmp)
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: logs.get(n) or _log(n) for n in names}


def _log(name: str) -> str:
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def call(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current and PyTorch's current
    stream there as the last argument; returns the C function's error code.

    Host time per launch matters where a kernel's device time is a few
    microseconds: the device switch is skipped when ``device`` is current,
    and the stream comes as the raw handle that PyTorch's own generated
    launchers read (``torch.cuda.current_stream()`` builds a Stream object,
    4-5 µs on an H100 host)."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def require_cuda(what: str, *tensors: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` (float32 by
    default) CUDA tensor on the same device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected CUDA tensors on one device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
