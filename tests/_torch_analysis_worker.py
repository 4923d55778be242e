"""The parity run of the two packages' atomics linters.

Run as a script, in its own process (so the reference's trace caches and
marker state never reach the process that runs `tests/test_analysis.py`),
it checks every twin of `tests/_torch_analysis_twins.py` with the port's
`repro_torch.analysis` beside its counterpart built here for the
reference's `repro.analysis`, on inputs drawn from ``--seed``, and the
reference's entry points beside the port's on the CPU, and prints one
JSON object:

    {"twins": {name: {"ref": [rule, ...], "ref_unlocated_a001": k,
                      "port": [rule, ...]}},
     "entries": {name: {"ref": [[rule, severity], ...] | {"error": ...},
                        "port": [[rule, severity], ...]}}}

with the unsuppressed findings of each entry.  The reference's A001s with
no location (its frame lookup fails on jax 0.9.0) are counted apart.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_analysis_twins import (EXECUTE_ONLY, PORT_TWINS,  # noqa: E402
                                   _inputs, run_port_twin)


# ---------------------------------------------------------------------------
# the reference's twins (`tests/test_analysis.py`), built in the worker only
# ---------------------------------------------------------------------------

def _reference_twins(seed):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import analysis as ra
    from repro import atomics as ja
    from repro.runtime.fault_tolerance import declare_donation as jdecl
    from repro.sharding import shard_map_compat

    idx, val, exp = (jnp.asarray(a) for a in _inputs(seed))

    def sds(shape, dtype=jnp.int32):
        return jax.ShapeDtypeStruct(shape, dtype)

    z8 = jnp.zeros((8,), jnp.int32)

    def table_write(t, i, v):
        return ja.AtomicTable(t).data.at[i].add(v)

    def table_arg(t, i, v):
        return t.data.at[i].set(v)

    def racy(buf, i, v):
        return buf.at[i].set(v)

    def unique(buf, v):
        return buf.at[jnp.arange(4)].set(v).at[
            jnp.array([3, 1, 0, 2])].set(v, unique_indices=True)

    def single(buf, i, v):
        return buf.at[i].set(v)

    def sanctioned(t, i, v):
        res = ja.execute(ja.AtomicTable(t), ja.Faa(i, v))
        return res.table.data, res.fetched

    def cas_add(t, i, e):
        return ja.execute(ja.AtomicTable(t),
                          ja.Cas(i, e + 1, expected=e)).table.data

    def cas_max(t, i, v, e):
        return ja.execute(ja.AtomicTable(t), ja.Cas(
            i, jnp.maximum(e, v), expected=e)).table.data

    def cas_noop(t, i, e):
        return ja.execute(ja.AtomicTable(t),
                          ja.Cas(i, e, expected=e)).fetched

    def cas_real(t, i, v, e):
        return ja.execute(ja.AtomicTable(t),
                          ja.Cas(i, v, expected=e)).table.data

    def cas_once(tab, i, v):
        res = ja.execute(ja.AtomicTable(tab),
                         ja.Cas(i, v, expected=jnp.int32(0)))
        return res.table.data, jnp.all(res.success)

    def unbounded(t, i, v):
        out, _ = jax.lax.while_loop(
            lambda c: ~c[1], lambda c: cas_once(c[0], i, v),
            (t, jnp.bool_(False)))
        return out

    def bounded(t, i, v):
        def body(c):
            new, done = cas_once(c[0], i, v)
            return new, done, c[2] + 1
        out, _, _ = jax.lax.while_loop(
            lambda c: ~c[1] & (c[2] < 16), body,
            (t, jnp.bool_(False), jnp.int32(0)))
        return out

    def cas_free(x):
        return jax.lax.while_loop(lambda c: jnp.any(c > 0),
                                  lambda c: c - 1, x)

    consume = jax.jit(lambda x: x * 2, donate_argnums=(0,))

    def read_after(x):
        y = consume(x)
        return y + x

    def unused_after(x):
        return consume(x) * 3

    step = jdecl(jax.jit(lambda s, st: st * 2, donate_argnums=(1,)), (1,))
    mesh = jax.make_mesh((1,), ("dev",))
    sp = P("dev")

    def shard_mapped(body):
        return shard_map_compat(body, mesh, (sp, sp, sp), (sp,))

    def outside(t, i, v):
        tbl = ja.AtomicTable(t, axis="dev")
        return ja.execute(tbl, ja.Faa(i, v)).table.data

    def inside(t, i, v):
        tbl = ja.AtomicTable(t, axis="dev")
        return (ja.execute(tbl, ja.Faa(i[0], v[0])).table.data,)

    def rev(t, i, v):
        tbl = ja.AtomicTable(t, axis="dev")
        r1 = ja.execute(tbl, ja.Swp(i[0], v[0]), need_fetched=False)
        r2 = ja.execute(r1.table, ja.Swp(i[0], v[0]), reverse_ranks=True,
                        need_fetched=False)
        return (r2.table.data,)

    def revert(t, i, v):
        tbl = ja.AtomicTable(t, axis="dev")
        r1 = ja.execute(tbl, ja.Swp(i[0], v[0]), need_fetched=True)
        r2 = ja.execute(r1.table, ja.Swp(i[0], r1.fetched),
                        reverse_ranks=True, need_fetched=False)
        return (r2.table.data,)

    c = ra.check
    f32 = jnp.float32
    s4 = (idx[None], val[None])
    return {
        "a001_table": lambda: c(table_write, sds((8,)), idx, val),
        "a001_table_arg": lambda: c(table_arg, ja.AtomicTable(z8), idx, val),
        "a001_aliasing_set": lambda: c(racy, sds((8,), f32), idx,
                                       val.astype(f32)),
        "a001_unique": lambda: c(unique, sds((8,), f32), val.astype(f32)),
        "a001_single": lambda: c(single, sds((8,)), idx[0], val[0]),
        "a001_sanctioned": lambda: c(sanctioned, z8, idx, val),
        "a002_faa": lambda: c(cas_add, z8, idx, exp),
        "a002_max": lambda: c(cas_max, z8, idx, val, exp),
        "a002_noop": lambda: c(cas_noop, z8, idx, exp),
        "a002_real": lambda: c(cas_real, z8, idx, val, exp),
        "a003_unbounded": lambda: c(unbounded, z8, idx, val),
        "a003_bounded": lambda: c(bounded, z8, idx, val),
        "a003_cas_free": lambda: c(cas_free, exp),
        "a004_read_after": lambda: c(read_after, val.astype(f32)),
        "a004_unused_after": lambda: c(unused_after, val.astype(f32)),
        "a004_recovery_captured": lambda: ra.check_recovery(
            step, jnp.zeros((4,))),
        "a004_recovery_factory": lambda: ra.check_recovery(
            step, lambda: jnp.zeros((4,))),
        "a005_outside": lambda: c(outside, z8, idx, val),
        "a005_inside": lambda: c(shard_mapped(inside), z8, *s4),
        "a005_reverse_no_fetch": lambda: c(shard_mapped(rev), z8, *s4),
        "a005_swp_revert": lambda: c(shard_mapped(revert), z8, *s4),
    }


def _unsuppressed_errors(findings):
    return sorted([f.rule, f.severity] for f in findings if not f.suppressed)


def main(seed: int, entries) -> dict:
    from repro.analysis import entries as ref_entries
    from repro_torch.analysis import entries as port_entries

    out = {"twins": {}, "entries": {}}
    ref = _reference_twins(seed)
    for name in PORT_TWINS:
        fs = ref[name]()
        # jax 0.9.0 hands the reference no frames for an equation (it
        # passes `user_frames` a SourceInfo, which wants a traceback), so on
        # a twin whose only writes are `execute`'s it flags the engine's own
        # scatters, with no location: set apart
        unlocated = [f for f in fs if f.rule == "A001" and f.file is None
                     and name in EXECUTE_ONLY]
        out["twins"][name] = {
            "ref": sorted(f.rule for f in fs if f not in unlocated),
            "ref_unlocated_a001": len(unlocated),
            "port": sorted(f.rule for f in run_port_twin(name, seed))}
    for name in entries:
        row = {}
        try:
            row["ref"] = _unsuppressed_errors(ref_entries.ENTRY_POINTS[name]())
        except Exception as e:  # noqa: BLE001 — recorded, not raised
            row["ref"] = {"error": f"{type(e).__name__}: {e}"}
        row["port"] = _unsuppressed_errors(
            port_entries.ENTRY_POINTS[name](device="cpu"))
        out["entries"][name] = row
    return out


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    names = sys.argv[2].split(",") if len(sys.argv) > 2 else []
    print(json.dumps(main(seed, names)), flush=True)
