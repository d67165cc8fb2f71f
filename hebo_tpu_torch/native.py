"""The repository's native host tools through ctypes (the port's own copy of
``hebo_tpu/native.py``; separate from ``ops/native.py``, which builds the
CUDA kernels).

Components (``native/src/``):
  * ``libhebo_native.so``: a threaded subprocess evaluation pool
    (eval_pool.cpp) that fans black-box commands out in parallel;
  * ``aig_opt``: the AIG logic-optimization tool (aig_opt.cpp) that the
    EDA and BOiLS tasks score operator sequences with.

Both are built by ``make`` (g++) into ``native/build/`` at first use.  The
build runs under a file lock into a private directory whose artifacts are
then renamed into place, so concurrent processes (test workers) neither
build twice at once nor see a half-written file.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from typing import List, Sequence, Tuple

__all__ = ["ensure_built", "run_commands", "aig_opt_path", "EvalPool"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_ARTIFACTS = ("libhebo_native.so", "aig_opt")
_LIB = None


def _built() -> bool:
    return all(os.path.exists(os.path.join(_BUILD_DIR, a)) for a in _ARTIFACTS)


def ensure_built() -> None:
    if _built():
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _built():  # another process built it while this one waited
            return
        tmp = tempfile.mkdtemp(prefix=".build-", dir=_BUILD_DIR)
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-j2", f"BUILD={tmp}"],
                           check=True, capture_output=True)
            for a in _ARTIFACTS:
                os.replace(os.path.join(tmp, a), os.path.join(_BUILD_DIR, a))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def _load():
    global _LIB
    if _LIB is None:
        ensure_built()
        _LIB = ctypes.CDLL(os.path.join(_BUILD_DIR, "libhebo_native.so"))
        _LIB.hn_run_commands.restype = ctypes.c_int
        _LIB.hn_run_commands.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        assert _LIB.hn_version() >= 10
    return _LIB


def aig_opt_path() -> str:
    ensure_built()
    return os.path.join(_BUILD_DIR, "aig_opt")


def run_commands(
    commands: Sequence[str],
    n_threads: int = 0,
    timeout_ms: int = 0,
    out_capacity: int = 65536,
) -> List[Tuple[int, str]]:
    """Run shell commands in the native thread pool; returns
    [(exit_code, stdout), ...] in input order."""
    lib = _load()
    n = len(commands)
    if n == 0:
        return []
    arr = (ctypes.c_char_p * n)(*[c.encode() for c in commands])
    codes = (ctypes.c_int * n)()
    buf = ctypes.create_string_buffer(n * out_capacity)
    lib.hn_run_commands(arr, n, n_threads, timeout_ms, codes, buf, out_capacity)
    out = []
    for i in range(n):
        raw = ctypes.string_at(ctypes.addressof(buf) + i * out_capacity)
        out.append((codes[i], raw.decode(errors="replace")))
    return out


class EvalPool:
    """Black-box fan-out helper: map a command template over points."""

    def __init__(self, n_threads: int = 0):
        self.n_threads = n_threads

    def map(self, commands: Sequence[str]) -> List[Tuple[int, str]]:
        return run_commands(commands, n_threads=self.n_threads)
