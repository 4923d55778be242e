"""Carry state between the JAX reference and the port.

The atomics tier's state is the atomic table (and the graph, which both
packages draw from the same numpy generator) plus the cost model's
:class:`HardwareSpec`; the model stack's is the LM's parameter tree, and
training's the AdamW state over it.  These helpers take that state across
as plain numpy arrays and dicts, so the port never imports the reference.

The reference stacks each stage's parameters on a leading axis of
``repeats``; the port keeps one block per layer.  `name_map` relates the
two: port name -> (the reference's dotted tree path, repeat index or None),
and `to_reference_layout` / `from_reference_layout` move a name-keyed dict
of tensors (parameters, gradients, master weights, moments) between the two
layouts, so tests compare them leaf by leaf.
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


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of a tree of mappings and lists/tuples."""
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (Mapping, list, tuple)):
            yield from _leaves(v, name + ".")
        else:
            yield name, v


def flatten_reference(tree) -> Dict[str, np.ndarray]:
    """The reference's tree (``LM.init``'s params, or a gradient or AdamW
    leaf tree of the same structure) as {dotted path: numpy array}, the
    stage lists indexed as ``stages.<i>.<j>.``."""
    return {name: np.asarray(arr) for name, arr in _leaves(tree)}


def name_map(model: LM) -> Dict[str, Tuple[str, Optional[int]]]:
    """Port parameter name -> (reference dotted path, repeat index), the
    index None outside the stages.  Repeat r of sub-layer j of stage i is
    the port's block ``offset_i + r * len(sigs) + j`` (jamba's periodic
    super-block maps the same way); names inside a block are the
    reference's keys (an MoE channel's ``moe.router``, ``moe.w1`` ...,
    MLA's ``attn.wq_a``, ``attn.q_norm.w`` ..., a decoder block's
    ``ln_cross.w`` and ``cross.wq`` ...).  The encoder's block ``r`` is
    repeat r of the reference's one encoder stage, ``enc_stages.0.0``;
    ``pos_embed``, ``enc_norm`` and ``enc_pos`` keep their names."""
    out: Dict[str, Tuple[str, Optional[int]]] = {}
    layer = 0
    for i, (sigs, reps) in enumerate(model.stages):
        for r in range(reps):
            for j in range(len(sigs)):
                for name, _ in model.blocks[layer].named_parameters():
                    out[f"blocks.{layer}.{name}"] = (f"stages.{i}.{j}.{name}",
                                                     r)
                layer += 1
    for name, _ in model.named_parameters():
        if name.startswith("enc_blocks."):
            _, r, rest = name.split(".", 2)
            out[name] = (f"enc_stages.0.0.{rest}", int(r))
        elif not name.startswith("blocks."):
            out[name] = (name, None)
    return out


def from_reference_layout(flat: Mapping[str, Any], model: LM, *,
                          device=None) -> Dict[str, torch.Tensor]:
    """{port name: tensor} from the reference's {dotted path: array}
    (`flatten_reference`), each repeat cut from its stage's stack; on
    ``device`` (default: the model's)."""
    device = model.device if device is None else device
    out = {}
    for name, (path, r) in name_map(model).items():
        arr = np.asarray(flat[path])
        out[name] = _tensor(arr if r is None else arr[r]).to(device)
    return out


def to_reference_layout(tensors: Mapping[str, torch.Tensor], model: LM
                        ) -> Dict[str, np.ndarray]:
    """{reference dotted path: numpy array} from {port name: tensor}: the
    repeats of each stage stacked on a leading axis, as the reference holds
    them.  bf16 comes back as f32 (exact)."""
    by_path: Dict[str, Dict[int, np.ndarray]] = {}
    out: Dict[str, np.ndarray] = {}
    for name, (path, r) in name_map(model).items():
        t = tensors[name].detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if r is None:
            out[path] = arr
        else:
            by_path.setdefault(path, {})[r] = arr
    for path, reps in by_path.items():
        out[path] = np.stack([reps[r] for r in sorted(reps)])
    return out


def lm_params_from_reference(params: Mapping, cfg: ModelConfig, *,
                             model: Optional[LM] = None,
                             device="cuda") -> LM:
    """Fill an :class:`LM` with the reference's ``LM.init`` tree (leaves as
    numpy arrays).  Builds the model on ``device`` unless one is given.

    Leaves map by `name_map`.  Every parameter of the model must be filled,
    with its own shape and dtype, and every leaf of the tree used, or this
    raises."""
    model = LM(cfg, device=device) if model is None else model
    flat = flatten_reference(params)
    names = name_map(model)
    unused = set(flat) - {path for path, _ in names.values()}
    if unused:
        raise KeyError(f"reference parameters with no counterpart: "
                       f"{sorted(unused)}")
    missing = sorted(n for n, (path, _) in names.items() if path not in flat)
    if missing:
        raise ValueError(f"parameters not in the reference tree: {missing}")
    own = dict(model.named_parameters())
    for name, src in from_reference_layout(flat, model,
                                           device="cpu").items():
        if tuple(src.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, "
                             f"port {tuple(own[name].shape)}")
        if src.dtype != own[name].dtype:
            raise TypeError(f"{name}: reference {src.dtype}, port "
                            f"{own[name].dtype}")
        own[name].data.copy_(src)
    return model


def adamw_state_from_reference(state: Mapping, model: LM, *, device=None
                               ) -> Dict[str, Any]:
    """The port's AdamW state (`optim.adamw.init_state`'s layout) from the
    reference's ``{"step", "master", "m", "v"}`` (leaves as numpy arrays;
    bf16 moments stay bf16)."""
    device = model.device if device is None else device
    out: Dict[str, Any] = {"step": torch.tensor(
        int(np.asarray(state["step"])), dtype=torch.int32, device=device)}
    for key in ("master", "m", "v"):
        out[key] = from_reference_layout(flatten_reference(state[key]),
                                         model, device=device)
    return out


def adamw_state_to_reference(state: Mapping, model: LM
                             ) -> Dict[str, Any]:
    """The port's AdamW state in the reference's layout: {"step": int,
    "master"/"m"/"v": {dotted path: numpy array}}."""
    out: Dict[str, Any] = {"step": int(state["step"])}
    for key in ("master", "m", "v"):
        out[key] = to_reference_layout(state[key], model)
    return out
