"""Rank side of `tests/test_torch_tuning.py`'s mesh cases.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("pod", "dev")`` mesh.  It
imports the port and numpy only: no JAX, and not the test suite's
conftest.
"""

import hashlib

import numpy as np
import torch

from repro_torch import atomics, telemetry
from repro_torch.core import perf_model, rmw_engine
from repro_torch.tuning import SpecController, TuningConfig

P0 = 1e-5


def _window(mesh, window: int) -> None:
    """One window of synthetic drift, skewed differently on every rank:
    rank 0 records 8 serialized events 2x slow (its window fills and
    fits), every other rank 3 events at ``1 + rank`` x (its own window
    would not fill, and would fit another spec if it did)."""
    n_events = 8 if mesh.rank == 0 else 3
    factor = 2.0 if mesh.rank == 0 else 1.0 + mesh.rank
    for _ in range(n_events):
        telemetry.record("atomics.execute", tier="local",
                         backend="serialized", op="faa", n=256,
                         predicted_s=P0, measured_s=P0 * factor
                         * (1.0 + 0.25 * window))


def ranks_agree(mesh):
    """Each rank runs a controller on the mesh over its own skewed
    windows; returns, after every `step()`, the outcome, the active
    tunable fields and the spec epoch, then the digests of a sharded
    contended CAS loop and FAA batches under the estimator and without."""
    cfg = TuningConfig(min_events=8, min_samples=2, cooldown_updates=0)
    log = []
    with SpecController(cfg, device="cpu", mesh=mesh) as ctrl:
        for w in range(5):
            _window(mesh, w)
            out = ctrl.step()
            log.append((out, perf_model.spec_to_dict(ctrl.active),
                        rmw_engine.spec_epoch(), ctrl.stats()))
        tuned = _sharded_workload(mesh)
        est = ctrl.estimator.snapshot()
    return {"log": log, "tuned": tuned, "untuned": _sharded_workload(mesh),
            "estimator": est, "live_after": rmw_engine.live_spec() is None}


def _sharded_workload(mesh):
    """int32: a contended CAS loop (64 ops over 8 slots) twice and 3 hot
    FAA batches on a (pod, dev)-sharded table of 256 slots."""
    t = lambda a: torch.as_tensor(a, dtype=torch.int32)
    tab = atomics.make_table(256, torch.int32, device="cpu", mesh=mesh,
                             axis=("pod", "dev"))

    def cas_ops(slots, observed):
        if slots is None:
            return atomics.Cas(t(np.arange(64) % 8), t(np.ones(64)),
                               expected=0)
        return observed + 1

    def faa_ops(slots, observed):
        if slots is None:
            return atomics.Faa(t(np.arange(128) % 4), t(np.arange(128)))
        return None

    h = hashlib.sha256()
    for make, rounds in ((cas_ops, 16), (faa_ops, 1), (cas_ops, 16),
                         (faa_ops, 1), (faa_ops, 1)):
        res = atomics.execute_until(tab, make, max_rounds=rounds)
        tab = res.table
        for a in (res.fetched, res.success, res.rounds):
            h.update(np.ascontiguousarray(a).tobytes())
    h.update(mesh.all_gather(tab.data, ("pod", "dev")).numpy().tobytes())
    return h.hexdigest()
