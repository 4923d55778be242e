"""Rank side of `tests/test_torch_sharded.py` and `tests/test_torch_retry.py`.

Each function here runs on every rank of a gloo group started by
`repro_torch.launch.ranks.launch` (8 ranks on a 2x4 ``("pod", "dev")``
mesh) and returns host arrays for the test process to hold against the
reference.  It imports the port and numpy only: no JAX, and not the test
suite's conftest.
"""

import numpy as np
import torch

from repro_torch import atomics
from repro_torch.atomics.layout import TableLayout
from repro_torch.core.bfs import bfs_sharded


def _np(t):
    return t.detach().cpu().numpy()


def run_cases(mesh, cases):
    """Every case of ``cases`` (dicts of numpy inputs for all ranks): this
    rank takes row ``mesh.rank`` of the batches and its shard of the
    table; returns per case its table shard, fetched, success and stats."""
    out = {}
    for c in cases:
        lay = TableLayout.from_mesh(
            mesh, num_slots=c["table"].shape[0], dtype=c["table"].dtype,
            axis=c["axis"], replica_axes=c["replica_axes"])
        lo, hi = lay.rows_of_shard(lay.shard_of_device(mesh.rank))
        table = atomics.AtomicTable(torch.from_numpy(c["table"][lo:hi]),
                                    axis=c["axis"],
                                    replica_axes=c["replica_axes"],
                                    mesh=mesh)
        idx = torch.from_numpy(c["idx"][mesh.rank])
        vals = torch.from_numpy(c["vals"][mesh.rank])
        if c["op"] == "cas":
            exp = c["exps"][mesh.rank] if c["perop"] else c["expected"]
            op = atomics.Cas(idx, vals, expected=torch.as_tensor(exp))
        else:
            op = atomics.OP_KINDS[c["op"]](idx, vals)
        res = atomics.execute(table, op, strategy=c["strategy"],
                              need_fetched=c["need_fetched"],
                              reverse_ranks=c["reverse"],
                              collect_stats=c["stats"])
        stats = None
        if c["stats"]:
            stats = {f: _np(v) for f, v in res.stats._asdict().items()}
        out[c["name"]] = dict(table=_np(res.table.data),
                              fetched=_np(res.fetched),
                              success=_np(res.success), stats=stats,
                              layout=res.table.layout().to_dict())
    return out


def run_bfs(mesh, src, dst, n, root):
    """`bfs_sharded` over the ``dev`` axis (each pod runs its own search on
    4 ranks), with the cas and the swp protocol."""
    return {op: _np(bfs_sharded(src, dst, n, root=root, mesh=mesh,
                                axis="dev", op=op, device="cpu").parent)
            for op in ("cas", "swp")}


def contended_make_ops(n, slot=0):
    """n CAS increments all on one slot: ``CAS(x, v, v + 1)``."""
    def make_ops(slots, observed):
        if slots is None:
            return atomics.Cas(torch.full((n,), slot, dtype=torch.int32),
                               torch.ones((n,), dtype=torch.int32),
                               expected=torch.zeros((n,), dtype=torch.int32))
        return atomics.Cas(slots, observed + 1, expected=observed)
    return make_ops


def run_retry(mesh, n, m, policies):
    """`execute_until` on a fully contended batch against a table of m
    slots sharded over the whole mesh, once per policy."""
    out = {}
    for name in policies:
        table = atomics.make_table(m, torch.int32, device="cpu", mesh=mesh,
                                   axis=("pod", "dev"))
        res = atomics.execute_until(table, contended_make_ops(n),
                                    max_rounds=4 * n, policy=name,
                                    sleep_fn=lambda s: None)
        out[name] = dict(n_rounds=res.n_rounds, rounds=res.rounds,
                         fetched=res.fetched, success=res.success,
                         pending=res.pending,
                         shards=_np(mesh.all_gather(res.table.data,
                                                    ("pod", "dev"))))
    return out


def run_card_pair(mesh, n, m):
    """Two ranks sharing the card: oneshot FAA and per-op CAS on a table
    sharded over both, on CUDA tensors (gloo; `Mesh.probe` stages what it
    refuses through the host).  Returns the results and the kernels'
    launch counts."""
    from repro_torch.kernels.rmw import kernel as K
    from repro_torch.kernels.serial import kernel as XK
    dev = torch.device("cuda")
    staged = mesh.probe(dev)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, m + 7, (2, n)).astype(np.int32)
    vals, exps = (rng.integers(-1, 2, (2, n)).astype(np.int32)
                  for _ in range(2))
    table0 = rng.integers(-1, 2, m).astype(np.int32)
    m_loc = m // 2
    mine = table0[mesh.rank * m_loc:(mesh.rank + 1) * m_loc]
    i, v, e = (torch.from_numpy(a[mesh.rank]).to(dev)
               for a in (idx, vals, exps))
    K.reset_launches()
    XK.reset_launches()
    out = dict(inputs=(idx, vals, exps, table0), host_staged=staged)
    for name, op in (("faa", atomics.Faa(i, v)),
                     ("cas_perop", atomics.Cas(i, v, expected=e))):
        table = atomics.AtomicTable(torch.from_numpy(mine).to(dev),
                                    axis="dev", mesh=mesh)
        res = atomics.execute(table, op, strategy="oneshot")
        out[name] = tuple(_np(t) for t in (res.table.data, res.fetched,
                                           res.success))
    out["launches"] = {**K.LAUNCHES, **XK.LAUNCHES}
    return out
