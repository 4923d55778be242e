"""Collective cost model built from the paper's per-hop R_O terms.

The paper models an atomic's cost as ownership-acquisition hops through the
memory hierarchy.  A mesh collective is the same object at scale: a schedule
of per-hop transfers, each costed as latency + bytes/bandwidth.  This module
prices the collectives the framework emits (ring all-reduce/all-gather/
reduce-scatter, bidirectional on the ICI torus; hierarchical over DCN) so that
`core/planner.py` can choose schedules analytically — the paper's
"use the model to pick the primitive" methodology (§6.1) applied to
distributed training.

This is the port's copy of `repro.core.collective_model` (pure Python, no
JAX), over the port's `perf_model` and `placement`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.perf_model import HardwareSpec
from repro_torch.core.placement import PlacementState, Tier

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "collective_permute")


@dataclass(frozen=True)
class MeshAxis:
    name: str
    size: int
    tier: Tier  # interconnect carrying this axis (ICI within pod, DCN across)


def _axis_link_Bps(spec: HardwareSpec, axis: MeshAxis) -> float:
    return spec.tier_bandwidth_Bps[axis.tier]


def _axis_hop_s(spec: HardwareSpec, axis: MeshAxis) -> float:
    return spec.tier_latency_s[axis.tier]


def collective_time_s(spec: HardwareSpec, kind: str, nbytes: int,
                      axis: MeshAxis, bidirectional: bool = True) -> float:
    """Time for one collective of `nbytes` (per-participant payload) on `axis`.

    Ring schedules (what XLA emits on ICI tori):
      all_gather / reduce_scatter: (n-1) steps, each moving nbytes/n.
      all_reduce: reduce_scatter + all_gather = 2(n-1) steps of nbytes/n.
      all_to_all: each chip exchanges nbytes*(n-1)/n total, bisection-limited.
      collective_permute: a single hop of nbytes.
    Bidirectional rings double effective link bandwidth (2 links per axis on
    a torus).
    """
    n = axis.size
    if n <= 1:
        return 0.0
    bw = _axis_link_Bps(spec, axis) * (2.0 if bidirectional else 1.0)
    hop = _axis_hop_s(spec, axis)
    if kind in ("all_gather", "reduce_scatter"):
        steps = n - 1
        return steps * (hop + (nbytes / n) / bw)
    if kind == "all_reduce":
        steps = 2 * (n - 1)
        return steps * (hop + (nbytes / n) / bw)
    if kind == "all_to_all":
        moved = nbytes * (n - 1) / n
        return hop * (n - 1) + moved / bw
    if kind == "collective_permute":
        return hop + nbytes / bw
    raise ValueError(f"unknown collective {kind!r}")


def collective_bytes_on_wire(kind: str, nbytes: int, n: int) -> int:
    """Bytes each participant puts on the wire (for the roofline term)."""
    if n <= 1:
        return 0
    if kind in ("all_gather", "reduce_scatter"):
        return int(nbytes * (n - 1) / n)
    if kind == "all_reduce":
        return int(2 * nbytes * (n - 1) / n)
    if kind == "all_to_all":
        return int(nbytes * (n - 1) / n)
    if kind == "collective_permute":
        return int(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


def grad_sync_strategies(spec: HardwareSpec, grad_bytes: int,
                         axis: MeshAxis) -> Dict[str, float]:
    """Price the gradient-synchronization alternatives the planner considers.

    * ``all_reduce``      — replicate-everywhere baseline.
    * ``zero`` (RS+AG)    — reduce-scatter grads, all-gather updated params;
                            same wire bytes but the optimizer update runs on
                            1/n of the state (memory win; time shown is wire
                            time only).
    * ``zero_int8``       — RS+AG with int8 error-feedback compression on this
                            axis (4x fewer bytes for fp32 grads).
    """
    ar = collective_time_s(spec, "all_reduce", grad_bytes, axis)
    rs = collective_time_s(spec, "reduce_scatter", grad_bytes, axis)
    ag = collective_time_s(spec, "all_gather", grad_bytes, axis)
    zero = rs + ag
    zero_int8 = (collective_time_s(spec, "reduce_scatter", grad_bytes // 4, axis)
                 + collective_time_s(spec, "all_gather", grad_bytes // 4, axis))
    return {"all_reduce": ar, "zero": zero, "zero_int8": zero_int8}


def cross_pod_hierarchical(spec: HardwareSpec, nbytes: int, ici_axis: MeshAxis,
                           dcn_axis: MeshAxis) -> float:
    """Hierarchical all-reduce: reduce-scatter within pod (ICI), all-reduce the
    1/n shard across pods (DCN), all-gather within pod.  This is the multi-pod
    gradient path; DCN carries only nbytes/ici_n per chip."""
    rs = collective_time_s(spec, "reduce_scatter", nbytes, ici_axis)
    ar = collective_time_s(spec, "all_reduce", nbytes // max(1, ici_axis.size),
                           dcn_axis)
    ag = collective_time_s(spec, "all_gather", nbytes, ici_axis)
    return rs + ar + ag
