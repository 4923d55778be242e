"""Train / prefill / decode step factories shared by the trainer and the
server.

Port of `repro.launch.steps`.  The reference's steps are pure functions of
explicit parameter pytrees; the port's model holds its weights, so a train
step takes the name-keyed parameter dict (`LM.named_parameters()`'s), loads
any tensor that is not the model's own into it (a restored checkpoint's),
differentiates `LM.loss` with autograd and applies AdamW in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state

Tensor = torch.Tensor


def _load(model: LM, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The model's own parameters, with ``params`` copied into any that
    ``params`` does not already hold."""
    own = dict(model.named_parameters())
    if params.keys() != own.keys():
        raise KeyError(f"parameter names differ from the model's: "
                       f"{sorted(set(params) ^ set(own))}")
    with torch.no_grad():
        for name, p in params.items():
            if p is not own[name]:
                own[name].copy_(p)
    return own


def _split(batch: Dict[str, Tensor], n: int) -> list:
    """``n`` microbatches cut along the batch axis (axis 1 of
    ``positions3``, (3, B, S))."""
    parts = [{} for _ in range(n)]
    for key, x in batch.items():
        ax = 1 if key == "positions3" else 0
        if x.shape[ax] % n:
            raise ValueError(f"batch axis of {key} ({x.shape[ax]}) does not "
                             f"divide into {n} microbatches")
        for part, piece in zip(parts, torch.chunk(x, n, dim=ax)):
            part[key] = piece
    return parts


def loss_and_grads(model: LM, batch: Dict[str, Tensor]
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(`LM.loss` on ``batch``, detached; {parameter name: its gradient}),
    every parameter's gradient materialised (zeros where unused)."""
    own = dict(model.named_parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, list(own.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(own, grads))


def reference_ndims(model: LM) -> Dict[str, int]:
    """Each parameter's rank in the reference's layout, where every block
    parameter carries its stage's stacking axis.  The reference decays
    leaves of rank >= 2, so its training decays every per-layer vector
    (norm weights, biases, ``A_log``, ``D``, ``dt_bias``) and not the final
    norm; the port keeps that function."""
    return {n: p.ndim + n.startswith("blocks.")
            for n, p in model.named_parameters()}


def make_train_step(model: LM, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {"loss", "lr", "grad_norm"} as 0-dim tensors.

    With microbatches > 1 the gradients of batch-axis slices accumulate in
    f32 (or wider) and are divided by the count, as the loss is.  Weight
    decay follows `reference_ndims`."""
    ndims = reference_ndims(model)

    def step(params, opt_state, batch):
        own = _load(model, params)
        if microbatches == 1:
            loss, grads = loss_and_grads(model, batch)
        else:
            loss, grads = None, None
            for part in _split(batch, microbatches):
                l, g = loss_and_grads(model, part)
                if grads is None:
                    loss = l.float()
                    grads = {n: x.to(torch.promote_types(x.dtype,
                                                         torch.float32))
                             for n, x in g.items()}
                else:
                    loss = loss + l
                    for n, x in g.items():
                        grads[n] += x
                del g
            loss = loss / microbatches
            grads = {n: x / microbatches for n, x in grads.items()}
        new_params, new_state, metrics = apply_updates(own, grads, opt_state,
                                                       opt_cfg, ndims)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return step


def make_prefill_step(model: LM, s_max: int) -> Callable:
    def step(params, batch):
        _load(model, params)
        return model.prefill(batch, s_max)
    return step


def make_decode_step(model: LM) -> Callable:
    def step(params, cache, batch):
        _load(model, params)
        return model.decode_step(cache, batch)
    return step


def abstract_train_state(model: LM, opt_cfg: AdamWConfig
                         ) -> Tuple[Dict[str, Tensor], Dict[str, Any]]:
    """Parameter and AdamW-state shapes and dtypes, as tensors on
    ``torch.device("meta")``: nothing is allocated or drawn."""
    meta = LM(model.cfg, device="meta", use_kernel=model.use_kernel,
              attn_impl=model.attn_impl, remat_policy=model.remat_policy,
              loss_chunk=model.loss_chunk)
    params = {n: p.detach() for n, p in meta.named_parameters()}
    return params, init_state(params, opt_cfg)
