"""Start a group of ranks on this host, one process each, and collect what
they return.

    results = ranks.launch("pkg.module:fn", 8, mesh=((2, 4), ("pod", "dev")),
                           args=(...,))

Every rank joins one ``torch.distributed`` world over a ``FileStore`` in a
fresh temporary directory (no fixed port), builds the
:class:`~repro_torch.launch.mesh.Mesh` and calls ``fn(mesh, *args)``; its
return value comes back pickled.  ``target`` is ``"module:function"`` or
``"path/to/file.py:function"``.  A rank that fails (or outlives
``timeout``) stops them all, and `launch` raises with its stderr.  The
ranks run on the card unless ``device="cpu"`` asks for the CPU: with
``device="cuda"`` every rank uses the current card (gloo ranks exchange
through the host; NCCL takes one card a rank); on the CPU each rank runs
one thread.

The worker side is this module run as ``python -m repro_torch.launch.ranks
SPEC RANK``.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

SRC = str(Path(__file__).resolve().parents[2])


class RankFailed(RuntimeError):
    """A rank exited non-zero or ran past the time limit."""


def launch(target: str, world: int, *,
           mesh: Tuple[Sequence[int], Sequence[str]], args: tuple = (),
           backend: str = "gloo", device: str = "cuda",
           timeout: Optional[float] = None,
           collective_timeout_s: float = 600.0) -> List[Any]:
    """Run ``target`` on ``world`` ranks; returns each rank's result."""
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_ranks_"))
    try:
        spec = dict(target=target, world=world, backend=backend,
                    device=device, mesh=(tuple(mesh[0]), tuple(mesh[1])),
                    args=args, init=f"file://{tmp / 'store'}",
                    collective_timeout_s=collective_timeout_s)
        torch.save(spec, tmp / "spec.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p])
        procs = []
        for r in range(world):
            with open(tmp / f"err{r}", "w") as err, \
                    open(tmp / f"log{r}", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.ranks",
                     str(tmp / "spec.pt"), str(r)],
                    stdout=out, stderr=err, env=env))
        _wait(procs, tmp, timeout)
        return [torch.load(tmp / f"out{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _wait(procs, tmp: Path, timeout: Optional[float]) -> None:
    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = timeout is not None and time.monotonic() - t0 > timeout
            if bad or late:
                r = bad[0] if bad else 0
                tail = (tmp / f"err{r}").read_text()[-4000:]
                why = (f"exited with {codes[r]}" if bad
                       else f"ran past {timeout} s")
                raise RankFailed(f"rank {r} of {len(procs)} {why}:\n{tail}")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _resolve(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _worker(spec_path: str, rank: int) -> None:
    from repro_torch.launch.mesh import Mesh
    spec = torch.load(spec_path, weights_only=False)
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(0)
    dist.init_process_group(
        spec["backend"], init_method=spec["init"], rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["collective_timeout_s"]))
    try:
        out = _resolve(spec["target"])(Mesh(*spec["mesh"]), *spec["args"])
        torch.save(out, Path(spec_path).parent / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
