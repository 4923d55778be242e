"""Placement states — the TPU analogue of the paper's cache-coherency states.

The paper parameterizes the cost of an atomic by the coherency state S of the
accessed cache line (M/E/S/O) *and* its proximity (local L1/L2/L3, remote die,
remote socket, memory).  On a TPU there is no dynamic coherence protocol; the
authoritative copy of a datum lives where the sharding puts it.  What survives
of the paper's S axis is therefore a *placement* axis (which memory tier / how
many interconnect hops away the owner is) plus a *replica count* (how many
copies must be invalidated-or-updated — the paper's Shared-vs-Exclusive
distinction, Eq. (7)/(8)).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Tier(enum.Enum):
    """Memory tier holding the authoritative copy (proximity axis)."""

    VREG = "vreg"                 # vector registers        (paper: local L1 hit)
    VMEM = "vmem"                 # on-chip scratchpad      (paper: local L2)
    HBM_LOCAL = "hbm_local"       # chip-local HBM          (paper: local L3/mem)
    ICI_NEIGHBOR = "ici_neighbor" # 1 ICI hop               (paper: on-chip remote core)
    ICI_FAR = "ici_far"           # multi-hop ICI (torus)   (paper: remote die, same CPU)
    DCN_REMOTE_POD = "dcn_remote" # different pod over DCN  (paper: remote socket)
    HOST = "host"                 # host DRAM over PCIe     (paper: main memory)


class Ownership(enum.Enum):
    """Replica-count abstraction of the paper's M/E/S/O states.

    EXCLUSIVE  — single authoritative copy (paper E/M): read-for-ownership is a
                 plain transfer, no invalidations (paper Eq. (2)).
    SHARED     — ``n_replicas`` copies exist (paper S/O): acquiring ownership
                 must invalidate/update all replicas; replicas act in parallel so
                 the *max* latency dominates (paper Eq. (7)).
    """

    EXCLUSIVE = "exclusive"
    SHARED = "shared"


@dataclass(frozen=True)
class PlacementState:
    """Full placement state S of an operand: (tier, ownership, replica count)."""

    tier: Tier
    ownership: Ownership = Ownership.EXCLUSIVE
    n_replicas: int = 1
    # Hop count for ICI_FAR placements (torus distance); ignored otherwise.
    hops: int = 1

    def __post_init__(self) -> None:
        if self.ownership is Ownership.SHARED and self.n_replicas < 2:
            raise ValueError("SHARED placement requires n_replicas >= 2")
        if self.ownership is Ownership.EXCLUSIVE and self.n_replicas != 1:
            raise ValueError("EXCLUSIVE placement requires n_replicas == 1")
        if self.hops < 1:
            raise ValueError("hops must be >= 1")

    @property
    def short(self) -> str:
        own = "E" if self.ownership is Ownership.EXCLUSIVE else f"S{self.n_replicas}"
        return f"{self.tier.value}/{own}"


# Convenience constructors mirroring the paper's benchmark axes -------------

def local(tier: Tier = Tier.HBM_LOCAL) -> PlacementState:
    return PlacementState(tier=tier)


def remote_chip(hops: int = 1) -> PlacementState:
    t = Tier.ICI_NEIGHBOR if hops == 1 else Tier.ICI_FAR
    return PlacementState(tier=t, hops=hops)


def remote_pod() -> PlacementState:
    return PlacementState(tier=Tier.DCN_REMOTE_POD)


def shared(tier: Tier, n_replicas: int) -> PlacementState:
    return PlacementState(tier=tier, ownership=Ownership.SHARED, n_replicas=n_replicas)
