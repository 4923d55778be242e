"""Cost-model exploration: the paper's L(A,S) model driving system choices.

Port of the reference's ``examples/cost_model_explore.py``::

    PYTHONPATH=src python -m repro_torch.examples.cost_model_explore

Walks through: (1) the three-term latency model across placement states,
(2) the ILP gap, (3) contention regimes, (4) the planner pricing gradient
sync / FSDP dtype / MoE capacity for a deepseek-v3-scale training step.
The numbers are the model's, over the reference's TPU v5e spec, as in the
reference: nothing here is measured.
"""

from repro_torch.core.contention import (contended_bandwidth_combining,
                                         contended_bandwidth_serialized)
from repro_torch.core.perf_model import (TPU_V5E, bandwidth, ilp_gap,
                                         latency, relaxed_bandwidth)
from repro_torch.core.placement import (PlacementState, Tier, remote_pod,
                                        shared)
from repro_torch.core.planner import (default_axes, plan_fsdp_gather_dtype,
                                      plan_grad_sync, plan_moe_dispatch)


def main() -> None:
    print("== L(A,S) across placement states (TPU v5e model), ns")
    states = {
        "VMEM local (E)": PlacementState(tier=Tier.VMEM),
        "HBM local (E)": PlacementState(tier=Tier.HBM_LOCAL),
        "ICI neighbor (E)": PlacementState(tier=Tier.ICI_NEIGHBOR),
        "ICI neighbor (S,8 replicas)": shared(Tier.ICI_NEIGHBOR, 8),
        "remote pod (DCN)": remote_pod(),
    }
    print(f"{'state':32s}" + "".join(f"{op:>10s}" for op in
                                     ("read", "faa", "swp", "cas")))
    for name, st in states.items():
        row = "".join(f"{latency(TPU_V5E, op, st)*1e9:10.0f}"
                      for op in ("read", "faa", "swp", "cas"))
        print(f"{name:32s}{row}")
    print("\n-> the paper's headline holds in the model: CAS≈FAA≈SWP; "
          "placement dominates.")

    st = PlacementState(tier=Tier.HBM_LOCAL)
    print(f"\n== ILP gap at HBM: serialized {bandwidth(TPU_V5E,'faa',st)/1e9:.2f} "
          f"GB/s vs relaxed {relaxed_bandwidth(TPU_V5E,st)/1e9:.0f} GB/s "
          f"({ilp_gap(TPU_V5E,'faa',st):.0f}x)")

    print("\n== contention (writers -> one shard), GB/s")
    print(f"{'writers':>8s}{'serialized':>12s}{'combining':>12s}")
    for w in (1, 4, 16, 64, 256):
        print(f"{w:8d}"
              f"{contended_bandwidth_serialized(TPU_V5E,'faa',w)/1e9:12.3f}"
              f"{contended_bandwidth_combining(TPU_V5E,'faa',w)/1e9:12.3f}")

    print("\n== planner: deepseek-v3 train step on (pod=2, data=16, model=16)")
    axes = default_axes({"pod": 2, "data": 16, "model": 16})
    grad_bytes = int(37.6e9 * 4 / 16)      # active-params grads, fp32, /TP
    d = plan_grad_sync(grad_bytes, axes["data"], axes["pod"])
    print(f"grad sync -> {d.choice}")
    for k, v in d.priced.items():
        print(f"  {k:12s} {v*1e3:8.2f} ms/step")
    d = plan_fsdp_gather_dtype(int(671e9 * 4 / 61 / 16), axes["data"])
    print(f"FSDP gather dtype -> {d.choice} ({d.priced})")
    d = plan_moe_dispatch(tokens_per_step=256 * 4096, n_experts=256, top_k=8,
                          ep_degree=16, step_budget_s=0.5)
    print(f"MoE dispatch -> {d.choice}")
    print(f"  note: {d.note}")


if __name__ == "__main__":
    main()
