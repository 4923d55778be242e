"""Cost-model-driven planning decisions (the paper's methodology as a feature).

The paper's §6.1 lesson: primitives cost the same, so *choose by semantics and
let the model price the alternatives*.  The planner applies that to the three
recurring choices the framework must make:

1. gradient-sync schedule per mesh axis (all-reduce vs ZeRO vs compressed),
2. FSDP gather dtype,
3. MoE dispatch capacity factor + drop semantics (SWP drop-newest vs
   CAS-priority keep-highest-gate), priced by the contention model.

Every decision returns the full priced table so EXPERIMENTS.md can show the
napkin math alongside the choice.

This is the port's copy of `repro.core.planner` (pure Python, no JAX), over
the port's `contention`, `collective_model` and `perf_model`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core import contention
from repro_torch.core.collective_model import (MeshAxis,
                                               cross_pod_hierarchical,
                                               grad_sync_strategies)
from repro_torch.core.perf_model import TPU_V5E, HardwareSpec
from repro_torch.core.placement import Tier


@dataclass(frozen=True)
class PlanDecision:
    choice: str
    priced: Dict[str, float] = field(default_factory=dict)
    note: str = ""


def plan_grad_sync(grad_bytes: int, data_axis: MeshAxis,
                   pod_axis: Optional[MeshAxis] = None,
                   spec: HardwareSpec = TPU_V5E,
                   allow_compression: bool = True) -> PlanDecision:
    """Pick the gradient synchronization schedule for the data axis (+pods)."""
    table = grad_sync_strategies(spec, grad_bytes, data_axis)
    if pod_axis is not None and pod_axis.size > 1:
        table = {k: v + cross_pod_hierarchical(
            spec, grad_bytes if k == "all_reduce" else grad_bytes // 4
            if k == "zero_int8" else grad_bytes, data_axis, pod_axis)
            for k, v in table.items()}
    candidates = dict(table)
    if not allow_compression:
        candidates.pop("zero_int8", None)
    choice = min(candidates, key=candidates.get)
    note = ("ZeRO (RS+AG) also shards optimizer state 1/n — preferred on ties; "
            "int8 path uses error-feedback to bound bias.")
    if choice == "all_reduce" and abs(
            candidates["all_reduce"] - candidates.get("zero", float("inf"))) \
            / max(candidates["all_reduce"], 1e-30) < 0.05:
        choice = "zero"  # tie-break toward the memory win
    return PlanDecision(choice=choice, priced=table, note=note)


def plan_fsdp_gather_dtype(param_bytes_fp32: int, axis: MeshAxis,
                           spec: HardwareSpec = TPU_V5E) -> PlanDecision:
    """bf16 vs fp32 all-gather of FSDP-sharded params inside the layer scan."""
    from repro_torch.core.collective_model import collective_time_s
    t32 = collective_time_s(spec, "all_gather", param_bytes_fp32, axis)
    t16 = collective_time_s(spec, "all_gather", param_bytes_fp32 // 2, axis)
    return PlanDecision(
        choice="bf16" if t16 < t32 else "fp32",
        priced={"fp32": t32, "bf16": t16},
        note="fp32 master weights stay sharded; bf16 copies are gathered.")


def plan_moe_dispatch(tokens_per_step: int, n_experts: int, top_k: int,
                      ep_degree: int, step_budget_s: float,
                      hot_fraction: float = 0.2,
                      spec: HardwareSpec = TPU_V5E) -> PlanDecision:
    """Capacity factor + overflow semantics from the contention model.

    The hot expert is the contended cache line (§5.4).  Capacity factor is
    sized so combining-mode dispatch absorbs the modeled hot load within the
    step budget; overflow semantics:
      * 'swp_drop_newest'  — overflowing tokens dropped (SWP: last loses),
      * 'cas_keep_top_gate'— overflow resolved by gate priority (CAS winner).
    The paper's finding that the primitives themselves cost the same means
    this is purely a semantics choice; we default to gate priority, which
    empirically (benchmarks/bfs.py analogue) loses less routed mass.
    """
    cap = contention.hot_expert_capacity(
        spec, tokens_per_step, n_experts, top_k, n_writers=ep_degree,
        hot_fraction=hot_fraction, step_budget_s=step_budget_s)
    cap = float(min(max(1.0, cap), 4.0))  # clamp to sane dispatch-buffer sizes
    bw_ser = contention.contended_bandwidth_serialized(spec, "faa", ep_degree)
    bw_comb = contention.contended_bandwidth_combining(spec, "faa", ep_degree)
    return PlanDecision(
        choice=f"capacity_factor={cap:.2f};overflow=cas_keep_top_gate",
        priced={"contended_serialized_Bps": bw_ser,
                "contended_combining_Bps": bw_comb,
                "capacity_factor": cap},
        note="combining-tree dispatch (paper §6.2.3 fix); overflow by gate "
             "priority (CAS semantics) rather than arrival order (SWP).")


def default_axes(mesh_shape: Dict[str, int]) -> Dict[str, MeshAxis]:
    """Name->MeshAxis helper matching launch/mesh.py conventions."""
    tiers = {"data": Tier.ICI_NEIGHBOR, "model": Tier.ICI_NEIGHBOR,
             "pod": Tier.DCN_REMOTE_POD}
    return {name: MeshAxis(name=name, size=size, tier=tiers.get(
        name, Tier.ICI_NEIGHBOR)) for name, size in mesh_shape.items()}
