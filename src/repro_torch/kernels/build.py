"""Build one CUDA source with nvcc and bind its C entries through ctypes.

Every kernel family of the port (`kernels/rmw`, `kernels/ssd`) declares one
:class:`NvccLibrary`: its ``csrc/*.cu`` source and the ``ctypes`` argument
types of each ``extern "C"`` entry.  The shared library goes to
``build/repro_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, the headers it includes by a quoted path
(`kernels/csrc/*.cuh`, found through ``-I kernels``) and the nvcc flags, so
an edit rebuilds and an unchanged checkout builds once.  Nothing happens
at import: :meth:`load` builds on first use.  Every entry returns
``cudaGetLastError()`` as an int.

`is_fake` is every wrapper's rule for a tensor that has no memory to
launch on (the dry run's, `launch.dryrun`): outputs of the right shape and
dtype, no launch, no count in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Mapping, NamedTuple, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: where ``#include "csrc/<header>.cuh"`` finds the headers the sources share
INCLUDE_DIR = Path(__file__).resolve().parent
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(INCLUDE_DIR))
_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def is_fake(t: torch.Tensor) -> bool:
    """True for a `FakeTensor` (``FakeTensorMode``): no memory behind it.
    The wrappers ask it after their CPU test and their checks of what the
    kernel takes, so a real launch pays one type check.  A plain tensor on
    the meta device is no fake: it launches, or raises."""
    return isinstance(t, FakeTensor)


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    log: str          # nvcc's output (-Xptxas -v: registers, smem, spills)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


class NvccLibrary:
    """One ``.cu`` source built into ``lib<stem>_<hash>.so``."""

    def __init__(self, stem: str, source: Path,
                 signatures: Mapping[str, Sequence]):
        self.stem = stem
        self.source = Path(source)
        self.signatures = dict(signatures)
        self._built: Optional[Built] = None
        self._lock = threading.Lock()

    def files(self) -> Sequence[Path]:
        """The source and every header it includes by a quoted path,
        transitively (as nvcc resolves them: beside the including file,
        else under `INCLUDE_DIR`)."""
        seen, todo = [], [self.source]
        while todo:
            f = todo.pop()
            if f in seen:
                continue
            seen.append(f)
            for name in _QUOTED_INCLUDE.findall(f.read_text()):
                for d in (f.parent, INCLUDE_DIR):
                    if (d / name).exists():
                        todo.append((d / name).resolve())
                        break
        return seen

    def digest(self) -> str:
        h = hashlib.sha256()
        for f in self.files():
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def load(self) -> Built:
        """Build (once per source hash) and load the library."""
        with self._lock:
            if self._built is None:
                self._built = self._build_and_bind()
            return self._built

    def _build_and_bind(self) -> Built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"lib{self.stem}_{self.digest()}.so"
        log_path = lib_path.with_suffix(".log")
        if not lib_path.exists():
            nvcc = nvcc_path()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                                   str(self.source)],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{log}")
            os.replace(tmp, lib_path)
            log_path.write_text(log)
        log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return Built(lib, lib_path, log)

    def launch(self, name: str, *args) -> None:
        """Call one C entry; raise if it reports a CUDA error."""
        rc = getattr(self.load().lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed with CUDA error {rc}")
