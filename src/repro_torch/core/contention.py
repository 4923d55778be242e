"""Contention model — paper §5.4 (Fig. 8a-c) adapted to TPU shards.

The paper measures n threads hammering one cache line: the line ping-pongs
between owners, so aggregate atomic bandwidth *collapses* instead of scaling.
The TPU analogue is n writers (cores or chips) combining into one table shard
(e.g. a hot MoE expert or a shared counter).

Two regimes are modeled:

* ``serialized``  — ownership ping-pong, the paper's measured hardware
  behaviour: each op must re-acquire the line from the previous owner
  (always a remote placement once n > 1).
* ``combining``   — a reduction tree (the software fix TPUs can apply, and
  the hardware fix the paper proposes in §6.2): writers pre-combine locally,
  then reduce up a log2(n) tree.

The crossover between the two is what the MoE capacity planner consumes.

This is the port's copy of `repro.core.contention` (pure Python, no JAX),
over the port's `perf_model` and `placement`.
"""

from __future__ import annotations

import math

from repro_torch.core.perf_model import (HardwareSpec, latency,
                                         read_for_ownership)
from repro_torch.core.placement import Ownership, PlacementState, Tier


def contended_bandwidth_serialized(spec: HardwareSpec, op: str, n_writers: int,
                                   remote_tier: Tier = Tier.ICI_NEIGHBOR,
                                   operand_bytes: int = 8) -> float:
    """Aggregate bytes/s of n writers RMW-ing one shard, ping-pong regime.

    n == 1: the owner hits its local tier at full serialized-atomic rate.
    n >= 2: every op's read-for-ownership targets the previous owner's cache —
    a remote placement in the S state with n replicas wanting the line.  The
    whole system completes one op per L(A, S_remote): aggregate bandwidth is
    *independent of n* (and far below n * single-writer) — the paper's Fig. 8
    plateau.  A mild sqrt(n) queueing penalty models the arbitration the
    paper observed on Xeon Phi/Bulldozer before the plateau.
    """
    if n_writers <= 1:
        local = PlacementState(tier=Tier.VMEM)
        return operand_bytes / latency(spec, op, local, operand_bytes)
    state = PlacementState(tier=remote_tier, ownership=Ownership.SHARED,
                           n_replicas=max(2, n_writers))
    l = latency(spec, op, state, operand_bytes)
    queue = 1.0 + 0.1 * math.sqrt(n_writers)
    return operand_bytes / (l * queue)


def contended_bandwidth_combining(spec: HardwareSpec, op: str, n_writers: int,
                                  remote_tier: Tier = Tier.ICI_NEIGHBOR,
                                  operand_bytes: int = 8,
                                  batch_per_writer: int = 1024) -> float:
    """Aggregate bytes/s under combining-tree reduction (the fix).

    Each writer locally pre-combines ``batch_per_writer`` operands (free ILP),
    then a binary reduction tree of depth ceil(log2 n) moves one combined
    operand per level.  Aggregate useful bandwidth grows ~linearly in n until
    the tree root's tier bandwidth saturates.
    """
    useful = n_writers * batch_per_writer * operand_bytes
    local_combine = batch_per_writer / spec.combine_ops_per_s
    depth = math.ceil(math.log2(max(2, n_writers)))
    hop = read_for_ownership(spec, PlacementState(tier=remote_tier), operand_bytes)
    t = local_combine + depth * (hop + spec.execute_s.get(op, 0.0))
    root_cap = spec.tier_bandwidth_Bps[remote_tier]
    return min(useful / t, root_cap * n_writers)


def contended_bandwidth_hierarchical(spec: HardwareSpec, op: str,
                                     n_pods: int, writers_per_pod: int,
                                     ici_tier: Tier = Tier.ICI_NEIGHBOR,
                                     dcn_tier: Tier = Tier.DCN_REMOTE_POD,
                                     operand_bytes: int = 8,
                                     batch_per_writer: int = 1024) -> float:
    """Aggregate bytes/s under *two-level* combining: per-pod ICI tree, then
    one cross-pod DCN reduction (the paper's §6.2 combining tree spanning
    pods; `core/rmw_sharded.py` is the executable realization).

    Relative to the flat tree of :func:`contended_bandwidth_combining` over
    all ``n_pods * writers_per_pod`` writers, the hierarchy pays the slow DCN
    hop only ``ceil(log2 n_pods)`` times instead of on every upper tree
    level — the crossover in favour of hierarchy grows with the DCN:ICI
    latency ratio and with per-pod writer count.  Includes the per-collective
    software launch (`HardwareSpec.collective_launch_s`), which is what keeps
    one-shot ahead for tiny uncontended batches.
    """
    n_writers = n_pods * writers_per_pod
    useful = n_writers * batch_per_writer * operand_bytes
    local_combine = batch_per_writer / max(spec.combine_ops_per_s, 1.0)
    ici_depth = math.ceil(math.log2(max(2, writers_per_pod)))
    dcn_depth = math.ceil(math.log2(max(2, n_pods))) if n_pods > 1 else 0
    ici_hop = read_for_ownership(spec, PlacementState(tier=ici_tier),
                                 operand_bytes)
    dcn_hop = read_for_ownership(spec, PlacementState(tier=dcn_tier),
                                 operand_bytes)
    e = spec.execute_s.get(op, 0.0)
    t = (local_combine + ici_depth * (ici_hop + e) + dcn_depth * (dcn_hop + e)
         + 2 * spec.collective_launch_s)
    root_cap = spec.tier_bandwidth_Bps[dcn_tier if n_pods > 1 else ici_tier]
    return min(useful / t, root_cap * n_writers)


def hierarchical_crossover_pods(spec: HardwareSpec, op: str,
                                writers_per_pod: int, max_pods: int = 64,
                                ici_tier: Tier = Tier.ICI_NEIGHBOR,
                                dcn_tier: Tier = Tier.DCN_REMOTE_POD,
                                operand_bytes: int = 8,
                                batch_per_writer: int = 1024) -> int:
    """Smallest pod count at which two-level combining beats the flat tree
    (paper Fig. 8 crossover, distributed edition); 0 if it never does.
    Both trees see the same tiers: the flat tree's every upper level rides
    the cross-pod `dcn_tier`."""
    for n_pods in range(2, max_pods + 1):
        flat = contended_bandwidth_combining(
            spec, op, n_pods * writers_per_pod, remote_tier=dcn_tier,
            operand_bytes=operand_bytes, batch_per_writer=batch_per_writer)
        hier = contended_bandwidth_hierarchical(
            spec, op, n_pods, writers_per_pod, ici_tier=ici_tier,
            dcn_tier=dcn_tier, operand_bytes=operand_bytes,
            batch_per_writer=batch_per_writer)
        if hier > flat:
            return n_pods
    return 0


def hot_expert_capacity(spec: HardwareSpec, tokens_per_step: int, n_experts: int,
                        top_k: int, n_writers: int,
                        hot_fraction: float = 0.2,
                        step_budget_s: float | None = None) -> float:
    """Capacity-factor suggestion from the contention model.

    A hot expert receiving ``hot_fraction`` of all routed tokens is the
    contended cache line.  We size the per-expert capacity so the combining
    regime (which the framework uses) keeps the dispatch within the step
    budget; returns the capacity factor (>= 1.0 means headroom).

    This realizes the paper's §6.1 message: choose the *semantics* (drop
    policy) from the model, because the primitive costs are equal.
    """
    assignments = tokens_per_step * top_k
    mean_per_expert = assignments / n_experts
    hot_load = hot_fraction * assignments
    bw = contended_bandwidth_combining(spec, "faa", n_writers)
    # time to absorb the hot expert's updates (8B routing record per token)
    t_hot = hot_load * 8 / bw
    if step_budget_s is None:
        step_budget_s = max(t_hot, 1e-9)
    # capacity factor that bounds dispatch time to the budget
    sustainable = bw * step_budget_s / 8
    return max(1.0, min(hot_load, sustainable) / max(mean_per_expert, 1.0))
