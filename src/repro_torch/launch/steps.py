"""Train / prefill / decode step factories shared by the trainer and the
server.

Port of `repro.launch.steps`.  The reference's steps are pure functions of
explicit parameter pytrees; the port's model holds its weights, so a train
step takes the name-keyed parameter dict (`LM.named_parameters()`'s), loads
any tensor that is not the model's own into it (a restored checkpoint's),
differentiates `LM.loss` with autograd and applies AdamW in place.

`make_sharded_train_step` is the same step on every rank of a mesh, each
rank holding only its blocks of the parameters and of AdamW's state
(`launch.shardings`), the reference's jitted step under its shardings.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.launch.mesh import gather_full, shard_of
from repro_torch.launch.shardings import batch_shardings, params_shardings
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


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def make_sharded_train_step(model: LM, opt_cfg: AdamWConfig, mesh,
                            rules: Dict[str, Any], microbatches: int = 1,
                            *, mean_of_means: bool = False) -> Callable:
    """(param blocks, AdamW-state blocks, global batch) -> (param blocks,
    state, metrics), called by every rank of ``mesh``; ``.specs`` holds
    each parameter's partition spec (`launch.shardings.params_shardings`).

    The rank gathers the whole parameters into ``model`` (`gather_full`),
    computes the loss and its gradients on its cut of each microbatch (the
    global batch's *i*-th cut, split by `batch_shardings`), weights them
    by its share of the microbatch's valid labels (the counts all-reduced),
    sums them over the axes the batch is split on, keeps its block of each
    and applies AdamW to its blocks, the clipping norm summed over the
    blocks (`optim.adamw.global_norm`).  So each rank's gradient block is
    the block of the global batch's gradient, the loss the mean over its
    valid labels: the local step's function.  Ranks that differ only
    along axes the batch is not split on compute the same cut, and hold
    the same bits of a block they share only under deterministic
    algorithms (`launch.train.deterministic_algorithms`), which `train`
    requires under a mesh.  ``mean_of_means`` weights every cut alike
    instead, which is wrong once the cuts' counts differ (the control of
    the tests).

    metrics: {"loss", "lr", "grad_norm"} as 0-dim tensors, and the host
    seconds (the card synchronised) of the step's three parts:
    ``gather_s``, ``compute_s`` (the label counts, forward and backward)
    and ``reduce_s`` (gradients, norm and AdamW)."""
    specs = params_shardings(model.cfg, dict(model.named_parameters()), mesh,
                             rules)
    ndims = reference_ndims(model)
    wide = torch.promote_types(model.dtype, torch.float32)

    def step(params, opt_state, batch):
        own = dict(model.named_parameters())
        t0 = _clock(model.device)
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(gather_full(params[name], specs[name], mesh))
        t1 = _clock(model.device)
        parts = _split(batch, microbatches) if microbatches > 1 else [batch]
        cut = batch_shardings(parts[0], mesh, rules)
        local = [{k: shard_of(x, cut[k], mesh) for k, x in part.items()}
                 for part in parts]
        red = cut["labels"][0] if cut["labels"] else ()
        counts = torch.stack([torch.sum(b["labels"] >= 0) for b in local]
                             ).to(wide)
        weights = (torch.full_like(counts, 1.0 / mesh.size(red))
                   if mean_of_means else
                   counts / torch.clamp(mesh.all_reduce(counts, red),
                                        min=1.0))
        loss, grads = None, None
        for w, part in zip(weights, local):
            l, g = loss_and_grads(model, part)
            l = l.to(wide) * w
            for n in g:              # one leaf at a time: no second copy
                g[n] = g[n].to(wide).mul_(w)
            if grads is None:
                loss, grads = l, g
            else:
                loss = loss + l
                for n, x in g.items():
                    grads[n] += x
            del g
        t2 = _clock(model.device)
        loss = mesh.all_reduce(loss, red) / microbatches
        blocks = {}
        for name in list(grads):
            full = mesh.all_reduce(grads.pop(name), red) / microbatches
            blocks[name] = shard_of(full, specs[name], mesh)
            del full
        new_params, new_state, metrics = apply_updates(
            params, blocks, opt_state, opt_cfg, ndims, mesh=mesh,
            specs=specs)
        t3 = _clock(model.device)
        metrics.update(loss=loss, gather_s=t1 - t0, compute_s=t2 - t1,
                       reduce_s=t3 - t2)
        return new_params, new_state, metrics

    step.specs = specs
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
