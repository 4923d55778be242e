"""Carry state between the JAX reference and the port.

The system has no weights: its state is the atomic table (and the graph,
which both packages draw from the same numpy generator) plus the cost
model's :class:`HardwareSpec`.  These helpers take that state across as
plain numpy arrays and dicts, so the port never imports the reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.atomics.table import AtomicTable
from repro_torch.core import perf_model
from repro_torch.core.placement import Tier


def table_from_numpy(arr, device="cuda") -> AtomicTable:
    """An :class:`AtomicTable` holding a copy of ``arr`` on ``device``."""
    return AtomicTable(torch.from_numpy(np.array(arr, copy=True)).to(device))


def table_to_numpy(table) -> np.ndarray:
    """The table's contents as a host numpy array."""
    data = table.data if isinstance(table, AtomicTable) else table
    return data.detach().cpu().numpy()


def _tier_key(key) -> str:
    """A tier key as the reference writes it: a `Tier` value string, or a
    reference `Tier` enum member, mapped by name."""
    if isinstance(key, str):
        return key
    return Tier[key.name].value


def spec_from_reference(d: Mapping) -> perf_model.HardwareSpec:
    """A port :class:`HardwareSpec` from the dict the reference's
    ``perf_model.spec_to_dict`` writes (or ``dataclasses.asdict`` of a
    reference spec, whose `Tier` keys are mapped by name)."""
    d = dict(d)
    for field_name in ("tier_latency_s", "tier_bandwidth_Bps"):
        if field_name in d:
            d[field_name] = {_tier_key(k): v for k, v in d[field_name].items()}
    if "residual_s" in d:
        d["residual_s"] = {
            (k if isinstance(k, str) else f"{k[0]}/{_tier_key(k[1])}"): v
            for k, v in d["residual_s"].items()}
    return perf_model.spec_from_dict(d)
