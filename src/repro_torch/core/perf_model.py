"""The paper's three-term performance model, adapted to TPU tiers.

Paper (Eq. 1):          L(A, S) = R_O(S) + E(A) + O
Bandwidth (Eq. 9):      B(A, S) = C_size / L(A, S)
Amortized bw (Eq. 10):  first access to a line pays L, subsequent N-1 operand
                        accesses within the line pay (R_L1 + E(A)) each.

Adaptation (see DESIGN.md §2): the cache line becomes a VMEM tile, the
coherency state S becomes a :class:`~repro.core.placement.PlacementState`
(tier × ownership × replica count), and the constants are held in a
:class:`HardwareSpec` — one analytically specified for the TPU v5e target and
one calibrated at runtime on the container's CPU by the benchmark harness
(mirroring the paper's per-architecture Table 2).

All latencies are in **seconds**, sizes in **bytes**, bandwidths in **bytes/s**.

This is the port's copy of `repro.core.perf_model` (pure Python, no JAX),
with one addition: the :data:`H100` spec the port's engine prices the card
with.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, Mapping, Tuple

from repro_torch.core.placement import Ownership, PlacementState, Tier

# ---------------------------------------------------------------------------
# RMW operation kinds (the paper's atomics)
# ---------------------------------------------------------------------------

#: Paper ops.  ``CAS2`` is the two-operands-fetched CAS variant of §5.5.
RMW_OPS = ("cas", "faa", "swp", "cas2", "read", "write")


@dataclass(frozen=True)
class HardwareSpec:
    """Constants of one architecture (the paper's Table 1 + Table 2 merged)."""

    name: str
    # Latency of fetching one tile ("cache line") with the authoritative copy
    # in each tier — the paper's R_{L1,l}, R_{L2,l}, R_{L3,l}, H, M.
    tier_latency_s: Mapping[Tier, float] = field(default_factory=dict)
    # Streaming bandwidth of each tier (for the size-dependent part of R_O).
    tier_bandwidth_Bps: Mapping[Tier, float] = field(default_factory=dict)
    # E(A): execute latency of each RMW op (paper Table 2 E rows).
    execute_s: Mapping[str, float] = field(default_factory=dict)
    # O: calibrated residual per (op, tier) — the paper's Table 3.
    residual_s: Mapping[Tuple[str, Tier], float] = field(default_factory=dict)
    # Tile ("cache line") geometry.
    tile_bytes: int = 8 * 128 * 4            # one fp32 VMEM tile (8 sublanes x 128 lanes)
    # Per-hop ICI latency for multi-hop placements (paper: H per die-die hop).
    ici_hop_s: float = 0.0
    # Peak compute + HBM bandwidth for roofline use.
    peak_flops: float = 0.0
    hbm_Bps: float = 0.0
    ici_link_Bps: float = 0.0
    # Relaxed/combining-mode per-element throughput (ops/s) — the ILP ceiling.
    combine_ops_per_s: float = 0.0
    # --- RMW-engine backend-selection constants (core/rmw_engine.py) ---
    # Per-element cost of ONE pass of a hardware sort network/merge phase;
    # the argsort backend pays ~log2(n) of these.  0 -> derived fallback.
    sort_elem_pass_s: float = 0.0
    # Amortized per-element random gather/scatter cost against a table that
    # fits the working tier (vectorized, pipelined — NOT a full miss).
    gather_elem_s: float = 0.0
    # Per-block loop-step overhead of the blocked one-hot backend (scan/DMA
    # bookkeeping per (batch-block) iteration).
    loop_step_s: float = 0.0
    # --- distributed-exchange terms (core/rmw_sharded.py, contention.py) ---
    # Per-link DCN bandwidth for cross-pod exchanges (the ICI analogue is
    # `ici_link_Bps`); tier_bandwidth_Bps[DCN_REMOTE_POD] stays the raw
    # streaming number while this is the per-collective effective rate.
    dcn_link_Bps: float = 0.0
    # Software dispatch cost of launching ONE collective (all_to_all /
    # psum_scatter ring setup) — dominates small contended exchanges and is
    # what makes hierarchical (3 collectives) lose to one-shot (2) on
    # uncontended batches.
    collective_launch_s: float = 0.0
    # --- migration terms (repro.atomics.reshard: elastic table moves) ---
    # Effective device<->host bandwidth of a full-table gather/scatter (the
    # host-roundtrip migration path); 0 -> tier_bandwidth_Bps[HOST].
    host_roundtrip_Bps: float = 0.0
    # Dispatch cost of one host->devices placement (device_put of a sharded
    # table) — the latency floor of the host-roundtrip path, what the
    # in-collective exchange path avoids.
    device_put_launch_s: float = 0.0

    def with_residuals(self, residual: Mapping[Tuple[str, Tier], float]) -> "HardwareSpec":
        return replace(self, residual_s=dict(residual))


# ---------------------------------------------------------------------------
# TPU v5e target constants (the modeled half; DESIGN.md §8 item 4)
# ---------------------------------------------------------------------------

_US = 1e-6
_NS = 1e-9

TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    tier_latency_s={
        Tier.VREG: 1 * _NS,            # register-file access
        Tier.VMEM: 20 * _NS,           # VMEM load-use
        Tier.HBM_LOCAL: 650 * _NS,     # HBM->VMEM DMA latency (small transfer)
        Tier.ICI_NEIGHBOR: 1.5 * _US,  # 1 ICI hop
        Tier.ICI_FAR: 1.5 * _US,       # per-hop; multiplied by `hops`
        Tier.DCN_REMOTE_POD: 50 * _US, # DCN round
        Tier.HOST: 5 * _US,            # PCIe
    },
    tier_bandwidth_Bps={
        Tier.VREG: 4e13,
        Tier.VMEM: 8e12,
        Tier.HBM_LOCAL: 819e9,
        Tier.ICI_NEIGHBOR: 50e9,
        Tier.ICI_FAR: 50e9,
        Tier.DCN_REMOTE_POD: 25e9,
        Tier.HOST: 16e9,
    },
    execute_s={"cas": 8 * _NS, "cas2": 10 * _NS, "faa": 6 * _NS, "swp": 6 * _NS,
               "read": 0.0, "write": 2 * _NS},
    ici_hop_s=1.5 * _US,
    peak_flops=197e12,
    hbm_Bps=819e9,
    ici_link_Bps=50e9,
    combine_ops_per_s=197e12 / 2,      # VPU-bound elementwise combine ceiling
    # TPUs sort badly (no sort network; lowered to O(log^2 n) bitonic passes
    # over the VPU) while one-hot contractions hit the MXU: bias accordingly.
    sort_elem_pass_s=4e-9,
    gather_elem_s=2e-9,
    loop_step_s=2e-6,
    dcn_link_Bps=25e9,
    collective_launch_s=1e-6,
    host_roundtrip_Bps=16e9,           # PCIe-bound full-table roundtrip
    device_put_launch_s=5e-6,
)


# ---------------------------------------------------------------------------
# NVIDIA H100 SXM constants (priors; the tier mapping of the port)
# ---------------------------------------------------------------------------
#
# Tier mapping: VREG -> registers, VMEM -> shared memory / L1,
# HBM_LOCAL -> HBM3, ICI_* -> NVLink, DCN_REMOTE_POD -> the host's network,
# HOST -> PCIe.  Bandwidths and peaks are NVIDIA's data-sheet numbers
# (3.35 TB/s HBM3, 450 GB/s NVLink each way, 67 TFLOP/s fp32 outside the
# tensor cores — the port's RMW paths run fp32/int32 on the CUDA cores);
# latencies and the RMW-engine constants are order-of-magnitude priors until
# a calibration runs on the card.  The engine constants describe *eager*
# PyTorch on the card: every plain-tensor step is a kernel launch, so the
# per-element costs carry launch amortisation and `loop_step_s` is one
# Python-loop block step (several launches).

H100 = HardwareSpec(
    name="h100_sxm",
    tier_latency_s={
        Tier.VREG: 0.5 * _NS,
        Tier.VMEM: 20 * _NS,           # shared memory / L1 load-use
        Tier.HBM_LOCAL: 600 * _NS,     # HBM3 load (L2 miss)
        Tier.ICI_NEIGHBOR: 2 * _US,    # NVLink peer access
        Tier.ICI_FAR: 2 * _US,
        Tier.DCN_REMOTE_POD: 50 * _US,
        Tier.HOST: 5 * _US,            # PCIe
    },
    tier_bandwidth_Bps={
        Tier.VREG: 1e14,
        Tier.VMEM: 3e13,               # 132 SMs x 128 B/clk
        Tier.HBM_LOCAL: 3.35e12,
        Tier.ICI_NEIGHBOR: 450e9,
        Tier.ICI_FAR: 450e9,
        Tier.DCN_REMOTE_POD: 50e9,
        Tier.HOST: 64e9,               # PCIe gen5 x16
    },
    execute_s={"cas": 10 * _NS, "cas2": 12 * _NS, "faa": 8 * _NS,
               "swp": 8 * _NS, "read": 0.0, "write": 2 * _NS},
    tile_bytes=128,                    # one L2 cache line
    ici_hop_s=2 * _US,
    peak_flops=67e12,
    hbm_Bps=3.35e12,
    ici_link_Bps=450e9,
    combine_ops_per_s=67e12 / 2,
    sort_elem_pass_s=2e-10,
    gather_elem_s=2e-9,
    loop_step_s=5e-5,
    dcn_link_Bps=50e9,
    collective_launch_s=1e-5,
    host_roundtrip_Bps=64e9,
    device_put_launch_s=1e-5,
)


def cpu_default_spec() -> HardwareSpec:
    """Uncalibrated CPU spec (order-of-magnitude priors; benchmarks calibrate it)."""
    return HardwareSpec(
        name="cpu_host",
        tier_latency_s={
            Tier.VREG: 0.3 * _NS,
            Tier.VMEM: 1.2 * _NS,      # L1/L2 in the CPU mapping
            Tier.HBM_LOCAL: 80 * _NS,  # DRAM
            Tier.ICI_NEIGHBOR: 100 * _NS,
            Tier.ICI_FAR: 100 * _NS,
            Tier.DCN_REMOTE_POD: 50 * _US,
            Tier.HOST: 80 * _NS,
        },
        tier_bandwidth_Bps={
            Tier.VREG: 1e12,
            Tier.VMEM: 4e11,
            Tier.HBM_LOCAL: 2e10,
            Tier.ICI_NEIGHBOR: 1e10,
            Tier.ICI_FAR: 1e10,
            Tier.DCN_REMOTE_POD: 1e9,
            Tier.HOST: 2e10,
        },
        execute_s={"cas": 5 * _NS, "cas2": 7 * _NS, "faa": 5 * _NS, "swp": 5 * _NS,
                   "read": 0.0, "write": 1 * _NS},
        tile_bytes=64,                 # the CPU's actual cache line
        ici_hop_s=100 * _NS,
        peak_flops=5e10,
        hbm_Bps=2e10,
        ici_link_Bps=1e10,
        combine_ops_per_s=2e9,
        # XLA:CPU's stable sort costs ~O(n log n) comparator work; gathers
        # are cheap while they hit cache.  Tuned against the committed
        # benchmarks/results/rmw_backends.json table for this container.
        sort_elem_pass_s=3e-9,
        gather_elem_s=1.5e-9,
        loop_step_s=1.5e-6,
        # fake-device "pods" on one host still pay XLA's collective dispatch
        dcn_link_Bps=1e9,
        collective_launch_s=2e-5,
        # host "roundtrip" on CPU devices is a memcpy, but each sharded
        # device_put pays Python/XLA placement dispatch per buffer
        host_roundtrip_Bps=1e10,
        device_put_launch_s=2e-4,
    )


# ---------------------------------------------------------------------------
# The model proper
# ---------------------------------------------------------------------------

def read_latency(spec: HardwareSpec, state: PlacementState,
                 nbytes: int | None = None) -> float:
    """R(S): plain-read latency of a tile whose authoritative copy is at S.tier.

    Implements the paper's Eq. (3)–(6) ladder: local-tier latency, plus hop
    penalties for remote tiers (H per hop, Eq. (6)/§4.1.3), plus a streaming
    term for payloads larger than the latency-dominated minimum.
    """
    nbytes = spec.tile_bytes if nbytes is None else nbytes
    base = spec.tier_latency_s[state.tier]
    if state.tier is Tier.ICI_FAR:
        base += spec.ici_hop_s * (state.hops - 1)
    stream = nbytes / spec.tier_bandwidth_Bps[state.tier]
    return base + stream


def read_for_ownership(spec: HardwareSpec, state: PlacementState,
                       nbytes: int | None = None) -> float:
    """R_O(S): acquire an exclusive copy, invalidating any replicas.

    EXCLUSIVE (paper E/M, Eq. (2)):  R_O = R(S).
    SHARED    (paper S/O, Eq. (8)):  R_O = R(E) + max_i R_i(E) — invalidations
    proceed in parallel, so one extra replica round-trip dominates regardless
    of replica count; a log2 fan-out term models multicast tree depth on the
    torus (replica count enters only logarithmically, consistent with the
    paper's observation that S-state latency is roughly replica-independent).
    """
    r = read_latency(spec, state, nbytes)
    if state.ownership is Ownership.EXCLUSIVE:
        return r
    inv = read_latency(spec, PlacementState(tier=state.tier, hops=state.hops), nbytes)
    fanout = math.log2(max(2, state.n_replicas))
    return r + inv * (1.0 + 0.1 * (fanout - 1.0))


def latency(spec: HardwareSpec, op: str, state: PlacementState,
            nbytes: int | None = None) -> float:
    """L(A, S) = R_O(S) + E(A) + O   (paper Eq. (1)).

    ``read`` does not acquire ownership; all RMW ops do (the paper found that
    even failing CAS issues the read-for-ownership — §5.1.1 last paragraph —
    so we model every RMW identically on that axis).
    """
    if op not in RMW_OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {RMW_OPS}")
    if op == "read":
        acquire = read_latency(spec, state, nbytes)
    else:
        acquire = read_for_ownership(spec, state, nbytes)
    if op == "cas2":  # two operands fetched (§5.5): second fetch pipelines,
        # costing only a pipelined local read, not a full round (paper: +2-4ns
        # local, +15-30ns remote).
        acquire += 0.25 * read_latency(spec, state, nbytes)
    execute = spec.execute_s.get(op, 0.0)
    o = spec.residual_s.get((op, state.tier), 0.0)
    return acquire + execute + o


def bandwidth(spec: HardwareSpec, op: str, state: PlacementState,
              operand_bytes: int = 8) -> float:
    """Serialized-atomics bandwidth, paper Eq. (9)/(10).

    Every tile ("cache line") load pays L(A,S); the remaining N-1 operands in
    the tile each pay a VREG-tier access plus E(A) — atomics are serialized
    (no ILP), the paper's insight I2.  Returns useful bytes/s.
    """
    n = max(1, spec.tile_bytes // operand_bytes)
    l_first = latency(spec, op, state)
    per_op = read_latency(spec, PlacementState(tier=Tier.VREG), operand_bytes) \
        + spec.execute_s.get(op, 0.0)
    total = l_first + (n - 1) * per_op
    return spec.tile_bytes / total


def relaxed_bandwidth(spec: HardwareSpec, state: PlacementState,
                      operand_bytes: int = 8) -> float:
    """Combining-mode bandwidth — the paper's proposed relaxed atomics (§6.2.3).

    Independent RMWs pipeline: throughput is min(tier streaming bandwidth,
    combine ALU ceiling).  The ratio relaxed/serialized reproduces the paper's
    5-30x atomics-vs-writes gap.
    """
    alu = spec.combine_ops_per_s * operand_bytes
    return min(spec.tier_bandwidth_Bps[state.tier], alu)


def ilp_gap(spec: HardwareSpec, op: str, state: PlacementState,
            operand_bytes: int = 8) -> float:
    """Modeled ratio of relaxed (write-like) to serialized (atomic) bandwidth."""
    return relaxed_bandwidth(spec, state, operand_bytes) / \
        bandwidth(spec, op, state, operand_bytes)


def unaligned_latency(spec: HardwareSpec, op: str, state: PlacementState) -> float:
    """Tile-spanning RMW (paper §5.7): both tiles must be owned atomically.

    The paper saw CAS jump to ~750ns — bus-lock semantics.  The TPU analogue
    of a tile-spanning combine is two dependent tile acquisitions plus a
    serialization penalty; we model L_unaligned = 2 L(A,S) + E(A).
    """
    return 2.0 * latency(spec, op, state) + spec.execute_s.get(op, 0.0)


# ---------------------------------------------------------------------------
# Persistence (benchmarks/calibrate.py writes, rmw_engine.default_spec loads)
# ---------------------------------------------------------------------------

def spec_to_dict(spec: HardwareSpec) -> Dict:
    """JSON-safe dict: Tier enums become their string values, residual keys
    become ``"op/tier"`` strings.  Inverse of :func:`spec_from_dict`."""
    import dataclasses
    d = dataclasses.asdict(spec)
    d["tier_latency_s"] = {t.value: v for t, v in spec.tier_latency_s.items()}
    d["tier_bandwidth_Bps"] = {t.value: v
                               for t, v in spec.tier_bandwidth_Bps.items()}
    d["residual_s"] = {f"{op}/{t.value}": v
                       for (op, t), v in spec.residual_s.items()}
    return d


def spec_from_dict(d: Mapping, base: HardwareSpec | None = None) -> HardwareSpec:
    """Rebuild a spec from :func:`spec_to_dict` output.  Unknown keys are
    ignored and missing ones inherit from ``base`` (so older calibration
    files keep working as the spec grows fields)."""
    base = base if base is not None else cpu_default_spec()
    by_value = {t.value: t for t in Tier}
    kw: Dict = {}
    for f in HardwareSpec.__dataclass_fields__:
        if f in d:
            kw[f] = d[f]
    if "tier_latency_s" in d:
        kw["tier_latency_s"] = {by_value[k]: float(v)
                                for k, v in d["tier_latency_s"].items()
                                if k in by_value}
    if "tier_bandwidth_Bps" in d:
        kw["tier_bandwidth_Bps"] = {by_value[k]: float(v)
                                    for k, v in d["tier_bandwidth_Bps"].items()
                                    if k in by_value}
    if "residual_s" in d:
        res = {}
        for k, v in d["residual_s"].items():
            op, _, tier = k.partition("/")
            if tier in by_value:
                res[(op, by_value[tier])] = float(v)
        kw["residual_s"] = res
    # tiers the file doesn't mention inherit the base spec's constants
    for field_name in ("tier_latency_s", "tier_bandwidth_Bps"):
        if field_name in kw:
            merged = dict(getattr(base, field_name))
            merged.update(kw[field_name])
            kw[field_name] = merged
    return replace(base, **kw)


# ---------------------------------------------------------------------------
# Calibration (the paper's §5 methodology: medians -> Table 2, residuals -> O)
# ---------------------------------------------------------------------------

def calibrate(spec: HardwareSpec,
              read_samples: Mapping[Tier, Iterable[float]],
              rmw_samples: Mapping[Tuple[str, Tier], Iterable[float]],
              ) -> HardwareSpec:
    """Fit tier latencies, execute costs, and residuals from measurements.

    Mirrors the paper exactly: tier latencies = median of read benchmarks
    (Table 2 R rows); E(A) = median over tiers of (L_measured - R); O =
    per-(op, tier) leftover (Table 3).
    """
    tier_lat = dict(spec.tier_latency_s)
    for tier, samples in read_samples.items():
        s = sorted(samples)
        if s:
            tier_lat[tier] = s[len(s) // 2]

    fitted = replace(spec, tier_latency_s=tier_lat)

    # E(A): median over (op, tier) of measured minus modeled acquisition.
    diffs: Dict[str, list] = {}
    medians: Dict[Tuple[str, Tier], float] = {}
    for (op, tier), samples in rmw_samples.items():
        s = sorted(samples)
        if not s:
            continue
        med = s[len(s) // 2]
        medians[(op, tier)] = med
        st = PlacementState(tier=tier)
        diffs.setdefault(op, []).append(med - read_for_ownership(fitted, st))
    execute = dict(spec.execute_s)
    for op, ds in diffs.items():
        ds = sorted(ds)
        execute[op] = max(0.0, ds[len(ds) // 2])
    fitted = replace(fitted, execute_s=execute)

    # O: residual per (op, tier) after the two fitted terms.
    residual: Dict[Tuple[str, Tier], float] = {}
    for (op, tier), med in medians.items():
        st = PlacementState(tier=tier)
        residual[(op, tier)] = med - (read_for_ownership(fitted, st)
                                      + execute.get(op, 0.0))
    return fitted.with_residuals(residual)
