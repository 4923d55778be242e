"""Build `csrc/rmw.cu` with nvcc and bind its C entries through ctypes.

The shared library goes to ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the nvcc
flags, so an edit rebuilds and an unchanged checkout builds once.  Nothing
happens at import: :func:`load` builds on first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmw.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # table, idx, vals, last_pos, n, m, op, dtype, stream
    "rmw_table_launch": (_P, _P, _P, _P, _LL, _LL, _I, _I, _P),
    # table, idx, vals, fetched, success, counters, n, m, op, dtype,
    # expected, stream
    "rmw_table_fetched_launch": (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                                 ctypes.c_double, _P),
    # idx, counts, n, m, stream
    "slot_counts_launch": (_P, _P, _LL, _LL, _P),
}


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    log: str          # nvcc's output (-Xptxas -v: registers, smem, spills)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the RMW kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once per source hash) and load the kernel library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"librmw_{_digest()}.so"
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        nvcc = nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
        log_path.write_text(log)
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Built(lib, lib_path, log)
