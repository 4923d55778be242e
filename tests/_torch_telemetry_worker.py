"""Rank side of `tests/test_torch_telemetry.py`'s sharded case.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("pod", "dev")`` mesh and
returns the events this rank recorded.  It imports the port and numpy
only: no JAX, and not the test suite's conftest.
"""

import numpy as np
import torch

from repro_torch import atomics, telemetry


def sharded_events(mesh):
    """One sharded `execute` (8 FAA ops a rank over 64 slots), one
    one-round `execute_until` of 32 FAA ops, then `migrate` by each path
    onto (dev,) shards with (pod,) replicas, all under ``capture(sync)``."""
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, 64, (4, 8))[mesh.rank],
                          dtype=torch.int32)

    def table():
        return atomics.make_table(64, torch.int32, device="cpu", mesh=mesh,
                                  axis=("pod", "dev"))

    def make_ops(slots, observed):
        if slots is None:
            return atomics.Faa(torch.arange(32, dtype=torch.int32),
                               torch.ones((32,), dtype=torch.int32))
        return None

    with telemetry.capture(sync=True) as buf:
        atomics.execute(table(), atomics.Faa(idx, torch.ones_like(idx)))
        atomics.execute_until(table(), make_ops, max_rounds=1)
        for path in ("exchange", "device_put"):
            atomics.reshard.migrate(table(), mesh, axis=("dev",),
                                    replica_axes=("pod",), path=path)
    return buf.events
