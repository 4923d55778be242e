"""Carry state between the JAX reference and the port.

The atomics tier's state is the atomic table (and the graph, which both
packages draw from the same numpy generator) plus the cost model's
:class:`HardwareSpec`; the model stack's is the LM's parameter tree.  These
helpers take that state across as plain numpy arrays and dicts, so the port
never imports the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.atomics.table import AtomicTable
from repro_torch.core import perf_model
from repro_torch.core.placement import Tier
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM


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


def _tensor(arr) -> torch.Tensor:
    """A host tensor from a numpy array; bfloat16 arrays (ml_dtypes, which
    torch.from_numpy does not take) go through f32, which is exact."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, name + ".")
        else:
            yield name, v


def lm_params_from_reference(params: Mapping, cfg: ModelConfig, *,
                             model: Optional[LM] = None,
                             device="cuda") -> LM:
    """Fill an :class:`LM` with the reference's ``LM.init`` tree (leaves as
    numpy arrays).  Builds the model on ``device`` unless one is given.

    The reference stacks each stage's parameters on a leading axis of
    ``repeats`` (``params["stages"][i][j]`` holds sub-layer j of stage i);
    repeat r of sub-layer j is the port's block
    ``offset_i + r * len(sigs) + j``; jamba's periodic super-block, whose
    sub-layers alternate MoE and dense channels, maps the same way.  An MoE
    channel's leaves (``moe.router``, ``moe.w1``/``w3``/``w2`` and
    ``moe.shared.*``) go to the block's `models.moe.MoE` by name.  Every
    parameter of the model must be filled, with its own shape and dtype, or
    this raises."""
    model = LM(cfg, device=device) if model is None else model
    own: Dict[str, torch.nn.Parameter] = dict(model.named_parameters())
    filled = set()

    def put(name, arr):
        if name not in own:
            raise KeyError(f"reference parameter {name} has no counterpart")
        src = _tensor(arr)
        if tuple(src.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, "
                             f"port {tuple(own[name].shape)}")
        if src.dtype != own[name].dtype:
            raise TypeError(f"{name}: reference {src.dtype}, port "
                            f"{own[name].dtype}")
        own[name].data.copy_(src)
        filled.add(name)

    for name, arr in _leaves({k: v for k, v in params.items()
                              if k != "stages"}):
        put(name, arr)
    layer = 0
    for i, (sigs, reps) in enumerate(model.stages):
        for r in range(reps):
            for j in range(len(sigs)):
                for name, arr in _leaves(params["stages"][i][j]):
                    put(f"blocks.{layer}.{name}", np.asarray(arr)[r])
                layer += 1
    missing = set(own) - filled
    if missing:
        raise ValueError(f"parameters not in the reference tree: "
                         f"{sorted(missing)}")
    return model
