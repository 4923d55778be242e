"""AdamW with f32 master weights and a configurable moment dtype.

Port of `repro.optim.adamw`, on a name-keyed dict of tensors (the LM's
``named_parameters()``) where the reference maps over a pytree.  The state
is ``{"step": int32 scalar, "master": {name: f32}, "m": {...}, "v":
{...}}``; the moments are kept in ``moment_dtype`` ("bfloat16" for the
largest models).  Master and moments are kept at least as wide as the
parameter (f64 for an f64 model, so a check in f64 stays f64 throughout).

The schedule, the bias corrections and the clip scale are f32 tensors on the
parameters' device, as the reference computes them on its device: Python
floats are f64, and using them would move the update by more than a
rounding.  `apply_updates` writes the new master weights, moments and
parameters into the tensors it was given (the reference donates them to its
jitted step), one parameter at a time, so its transient memory is a few
copies of the largest parameter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"        # "bfloat16" for the >300B models
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, device) -> Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32."""
    dev = step.device
    step = step.float()
    warm = step / _f32(max(cfg.warmup_steps, 1), dev)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              dev), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(
        step < cfg.warmup_steps, _f32(1.0, dev), cos)


def _wide(dtype: torch.dtype, at_least: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, at_least)


def init_state(params: Mapping[str, Tensor], cfg: AdamWConfig
               ) -> Dict[str, object]:
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    first = next(iter(params.values()))

    def zeros(p):
        dt = mdt if p.dtype != torch.float64 else torch.float64
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "master": {n: p.detach().to(_wide(p.dtype, torch.float32),
                                        copy=True)
                       for n, p in params.items()},
            "m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()}}


def _sum_squares(x: Tensor) -> Tensor:
    return torch.sum(torch.square(x.to(_wide(x.dtype, torch.float32))))


def global_norm(tree: Mapping[str, Tensor], mesh=None,
                specs: Optional[Mapping[str, tuple]] = None) -> Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32 (or wider).

    Under ``mesh`` the leaves are this rank's blocks by ``specs``
    (`repro_torch.sharding` partition specs): each leaf's squares are
    summed over the mesh axes its spec shards it on, and over no other
    axis, so a leaf replicated along an axis counts once."""
    if mesh is None:
        return torch.sqrt(torch.sum(torch.stack(
            [_sum_squares(x) for x in tree.values()])))
    by_axes: Dict[tuple, list] = {}
    for name, x in tree.items():
        on = {a for e in specs[name] if e
              for a in ((e,) if isinstance(e, str) else e)}
        axes = tuple(a for a in mesh.axis_names if a in on)
        by_axes.setdefault(axes, []).append(_sum_squares(x))
    total = [mesh.all_reduce(torch.sum(torch.stack(parts)), axes)
             for axes, parts in sorted(by_axes.items())]
    return torch.sqrt(torch.sum(torch.stack(total)))


@torch.no_grad()
def apply_updates(params: Mapping[str, Tensor], grads: Mapping[str, Tensor],
                  state: Dict[str, object], cfg: AdamWConfig,
                  ndims: Optional[Mapping[str, int]] = None, *, mesh=None,
                  specs: Optional[Mapping[str, tuple]] = None
                  ) -> Tuple[Mapping[str, Tensor], Dict[str, object],
                             Dict[str, Tensor]]:
    """One AdamW step.  Returns (params, new state, {"lr", "grad_norm"});
    the parameters, master weights and moments are updated in place.
    Weight decay applies to leaves of rank >= 2; ``ndims`` gives the rank
    to test where it is not the tensor's own (`launch.steps` passes the
    ranks of the reference's stacked layout).  Under ``mesh`` every tensor
    is this rank's block by ``specs``, and the clipping norm is the whole
    gradient's (`global_norm`)."""
    step = state["step"] + 1
    dev = step.device
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, mesh, specs)
    if cfg.grad_clip > 0:
        scale = torch.clamp(_f32(cfg.grad_clip, dev)
                            / torch.clamp(gnorm, min=1e-12), max=1.0)
    else:
        scale = _f32(1.0, dev)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, dev), step.float())
    bc2 = 1 - torch.pow(_f32(b2, dev), step.float())
    for name, p in params.items():
        mas, m, v = state["master"][name], state["m"][name], state["v"][name]
        wide = mas.dtype
        gf = grads[name].to(wide) * scale
        m32 = m.to(wide) * b1 + (1 - b1) * gf
        v32 = v.to(wide) * b2 + (1 - b2) * gf * gf
        del gf
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        ndim = p.ndim if ndims is None else ndims[name]
        decay = cfg.weight_decay if ndim >= 2 else 0.0
        mas.copy_(mas - lr * (delta + decay * mas))
        del delta
        p.copy_(mas)
    new_state = {"step": step, "master": state["master"], "m": state["m"],
                 "v": state["v"]}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
