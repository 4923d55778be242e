"""The port's rule twins for its atomics linter: one bad and one good
function a rule, with their inputs from a seed and the rules each must
fire.

Imported by `tests/test_torch_analysis.py`, `tests/_torch_analysis_worker.py`
(the parity run against the reference) and `chip_smoke.py`'s `analysis`
phase; it imports torch and the port only, no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import analysis, atomics
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.runtime.fault_tolerance import declare_donation

I32 = torch.int32
spec = analysis.spec


def _inputs(seed, n=4, m=8):
    """Indices (distinct, so a CAS round on zeros resolves every op),
    values and expected values for a twin, from ``seed``."""
    rng = np.random.default_rng(seed)
    return (rng.permutation(m)[:n].astype(np.int32),
            rng.integers(1, 100, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# the port's twins: name -> (fn(*args), args(seed), kind); kind "check"
# runs analysis.check on the CPU, "recovery" analysis.check_recovery
# ---------------------------------------------------------------------------

def _p_a001_table(t, idx, v):
    tbl = atomics.AtomicTable(t)
    return tbl.data.index_put_((idx.long(),), v, accumulate=True)


def _p_a001_table_arg(t, idx, v):
    d = t.data
    d[idx.long()] = v
    return d


def _p_a001_aliasing_set(buf, idx, v):
    out = buf.clone()
    out[idx.long()] = v
    return out


def _p_a001_unique(buf, v):
    out = buf.clone()
    out[torch.arange(4)] = v
    out[torch.tensor([3, 1, 0, 2])] = v
    return out


def _p_a001_single(buf, i, v):
    out = buf.clone()
    out[i] = v
    return out


def _p_sanctioned(t, i, v):
    res = atomics.execute(atomics.AtomicTable(t), atomics.Faa(i, v))
    return res.table.data, res.fetched


def _p_a002_faa(t, i, e):
    op = atomics.Cas(i, e + 1, expected=e)
    return atomics.execute(atomics.AtomicTable(t), op).table.data


def _p_a002_max(t, i, v, e):
    op = atomics.Cas(i, torch.maximum(e, v), expected=e)
    return atomics.execute(atomics.AtomicTable(t), op).table.data


def _p_a002_noop(t, i, e):
    op = atomics.Cas(i, e, expected=e)
    return atomics.execute(atomics.AtomicTable(t), op).fetched


def _p_a002_real(t, i, v, e):
    op = atomics.Cas(i, v, expected=e)
    return atomics.execute(atomics.AtomicTable(t), op).table.data


def _p_cas_once(tab, i, v):
    res = atomics.execute(atomics.AtomicTable(tab),
                          atomics.Cas(i, v, expected=0))
    return res.table.data, bool(res.success.all())


def _p_a003_unbounded(t, i, v):
    done = False
    while not done:
        t, done = _p_cas_once(t, i, v)
    return t


def _p_a003_bounded(t, i, v):
    done, r = False, 0
    while not done and r < 16:
        t, done = _p_cas_once(t, i, v)
        r += 1
    return t


def _p_a003_cas_free(x):
    while bool((x > 0).any()):
        x = x - 1
    return x


_consume = declare_donation(lambda x: x.mul_(2), (0,))


def _p_a004_read_after(x):
    y = _consume(x)
    return y + x                       # x is read after being donated


def _p_a004_unused_after(x):
    return _consume(x) * 3


def _step(s, st):
    return st.mul_(2)


_MESH = RecordingMesh((1,), ("dev",))


def _p_a005_outside(t, i, v):
    tbl = atomics.AtomicTable(t, axis="dev")
    return atomics.execute(tbl, atomics.Faa(i, v)).table.data


def _p_a005_inside(t, i, v):
    tbl = atomics.AtomicTable(t, axis="dev", mesh=_MESH)
    return atomics.execute(tbl, atomics.Faa(i, v)).table.data


def _p_a005_reverse_no_fetch(t, i, v):
    tbl = atomics.AtomicTable(t, axis="dev", mesh=_MESH)
    r1 = atomics.execute(tbl, atomics.Swp(i, v), need_fetched=False)
    r2 = atomics.execute(r1.table, atomics.Swp(i, v), reverse_ranks=True,
                         need_fetched=False)
    return r2.table.data


def _p_a005_swp_revert(t, i, v):
    tbl = atomics.AtomicTable(t, axis="dev", mesh=_MESH)
    r1 = atomics.execute(tbl, atomics.Swp(i, v), need_fetched=True)
    r2 = atomics.execute(r1.table, atomics.Swp(i, r1.fetched),
                         reverse_ranks=True, need_fetched=False)
    return r2.table.data


def _zeros8():
    return torch.zeros(8, dtype=I32)


#: name -> (fn, args(seed), kind, the rule ids it must give)
PORT_TWINS = {
    "a001_table": (_p_a001_table, lambda s: (
        spec((8,), I32), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check",
        ["A001"]),
    "a001_table_arg": (_p_a001_table_arg, lambda s: (
        atomics.AtomicTable(_zeros8()), _t(_inputs(s)[0]),
        _t(_inputs(s)[1])), "check", ["A001"]),
    "a001_aliasing_set": (_p_a001_aliasing_set, lambda s: (
        spec((8,)), _t(_inputs(s)[0]), _t(_inputs(s)[1]).float()),
        "check", ["A001"]),
    "a001_unique": (_p_a001_unique, lambda s: (
        spec((8,)), _t(_inputs(s)[1]).float()), "check", []),
    "a001_single": (_p_a001_single, lambda s: (
        spec((8,), I32), _t(_inputs(s)[0][0]), _t(_inputs(s)[1][0])),
        "check", []),
    "a001_sanctioned": (_p_sanctioned, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check", []),
    "a002_faa": (_p_a002_faa, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[2])), "check",
        ["A002"]),
    "a002_max": (_p_a002_max, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1]), _t(_inputs(s)[2])),
        "check", ["A002"]),
    "a002_noop": (_p_a002_noop, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[2])), "check",
        ["A002"]),
    "a002_real": (_p_a002_real, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1]), _t(_inputs(s)[2])),
        "check", []),
    "a003_unbounded": (_p_a003_unbounded, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check",
        ["A003"]),
    "a003_bounded": (_p_a003_bounded, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check", []),
    "a003_cas_free": (_p_a003_cas_free, lambda s: (
        _t(_inputs(s)[2]),), "check", []),
    "a004_read_after": (_p_a004_read_after, lambda s: (
        _t(_inputs(s)[1]).float(),), "check", ["A004"]),
    "a004_unused_after": (_p_a004_unused_after, lambda s: (
        _t(_inputs(s)[1]).float(),), "check", []),
    "a004_recovery_captured": (declare_donation(_step, (1,)), lambda s: (
        torch.zeros(4),), "recovery", ["A004"]),
    "a004_recovery_factory": (declare_donation(_step, (1,)), lambda s: (
        lambda: torch.zeros(4),), "recovery", []),
    "a005_outside": (_p_a005_outside, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check",
        ["A005"]),
    "a005_inside": (_p_a005_inside, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check", []),
    "a005_reverse_no_fetch": (_p_a005_reverse_no_fetch, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check",
        ["A005"]),
    "a005_swp_revert": (_p_a005_swp_revert, lambda s: (
        _zeros8(), _t(_inputs(s)[0]), _t(_inputs(s)[1])), "check", []),
}


#: twins that write no buffer themselves, only through `atomics.execute`
EXECUTE_ONLY = frozenset(n for n in PORT_TWINS if n.startswith(
    ("a001_sanctioned", "a002", "a003_unbounded", "a003_bounded",
     "a005_inside", "a005_reverse", "a005_swp")))


def _on(device, x):
    """``x`` with its tensors (and tables' data) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, atomics.AtomicTable):
        return x.with_data(x.data.to(device))
    return x


def run_port_twin(name, seed, device="cpu"):
    """The twin's findings, its arguments from ``seed`` on ``device``."""
    fn, make, kind, _ = PORT_TWINS[name]
    args = [_on(device, a) for a in make(seed)]
    if kind == "recovery":
        return analysis.check_recovery(fn, *args)
    return analysis.check(fn, *args, device=device)
