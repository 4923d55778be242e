"""Train / prefill / decode step factories shared by the trainer and the
server.

Port of `repro.launch.steps`.  The reference's steps are pure functions of
explicit parameter pytrees; the port's model holds its weights, so a train
step takes the name-keyed parameter dict (`LM.named_parameters()`'s), loads
any tensor that is not the model's own into it (a restored checkpoint's),
differentiates `LM.loss` with autograd and applies AdamW in place.

`make_sharded_train_step` is the same step on every rank of a mesh, each
rank holding only its blocks of the parameters and of AdamW's state
(`launch.shardings`) and computing the GQA attention, dense MLP and
vocabulary leaves the rules cut on its ``"model"`` cut: the reference's
jitted step under its shardings, partitioned as XLA partitions it.

`make_sharded_prefill_step` and `make_sharded_decode_step` are the
reference's jitted serving steps under `params_shardings` and
`cache_shardings` (`arch_rules(..., "prefill" | "decode")`): each rank
holds its KV cache blocks, cut by sequence over ``"model"``, and computes
the same leaves on its ``"model"`` cut; decode combines the ranks'
attention partials (`launch.mesh.combine_partials`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.launch.mesh import gather_full, shard_of, use_mesh
from repro_torch.launch.shardings import (ModelCut, batch_shardings,
                                         cache_shardings, model_cuts,
                                         params_shardings)
from repro_torch.models import moe, tensor_parallel
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
                            *, mean_of_means: bool = False,
                            sum_partial: bool = True,
                            partitioned: bool = True) -> Callable:
    """(param blocks, AdamW-state blocks, global batch) -> (param blocks,
    state, metrics), called by every rank of ``mesh``; ``.specs`` holds
    each parameter's partition spec (`launch.shardings.params_shardings`)
    and ``.cuts`` how the step computes with it along ``"model"``
    (`launch.shardings.model_cuts`).

    The rank computes the loss on its cut of each microbatch (the global
    batch's *i*-th cut, split by `batch_shardings`), weighted by its share
    of the microbatch's valid labels (the counts all-reduced) before the
    backward, and, as the reference's partitioned step, on its ``"model"``
    cut of every GQA attention, dense MLP and vocabulary leaf the rules
    cut: such a leaf ("cut") is gathered over its other axes only and
    handed to the model as the rank's block (`models.tensor_parallel.
    cuts`), which runs the column and row products on it and sums their
    outputs over ``"model"``.  Every other leaf is gathered whole into
    ``model`` (`gather_full`).  Ranks along ``"model"`` then hold the
    same activations between the layers.

    After the backward each gradient is summed over the axes the batch is
    split on and cut back to the block.  A "partial" leaf (whole along
    ``"model"`` inside a layer that computes on the cut: gemma_2b's
    ``wk`` / ``wv`` at one kv head, kv heads left whole beside cut query
    heads) holds on each rank the part its query heads use, so it is
    summed over ``"model"`` too; ``sum_partial=False`` leaves it partial
    (the control of the tests).  A leaf applied to the replicated
    activations (norms, ``b2``, attention whose heads do not divide) has
    equal gradients along ``"model"`` and counts once.  AdamW runs on the
    blocks, the clipping norm summed over them
    (`optim.adamw.global_norm`).

    Expert weights differ where the mesh runs expert parallelism
    (`models.moe.expert_parallel`): they are never gathered whole.  The
    layer takes the rank's blocks (`models.moe.training_blocks`), gathers
    their rows over the batch's axes itself, and its backward sums their
    gradient over those axes and cuts it back to the block, so the step
    neither all-reduces nor cuts it.  That sum is why the weight must
    scale the loss, not the gradients after the backward.

    ``partitioned=False`` gathers every leaf whole and computes it alike
    along ``"model"``, on the same blocks: the unpartitioned step, for
    comparison.  (Rules that map ``qkv``, ``kv_qkv``, ``ffn`` and
    ``vocab`` to None compute the same, but also keep those leaves whole
    in every rank's state.)

    So each rank's gradient block is the block of the global batch's
    gradient, the loss the mean over its valid labels: the local step's
    function.  Ranks that differ only
    along axes the batch is not split on compute the same cut, and hold
    the same bits of a block they share only under deterministic
    algorithms (`launch.train.deterministic_algorithms`), which `train`
    requires under a mesh.  ``mean_of_means`` weights every cut alike
    instead, which is wrong once the cuts' counts differ (the control of
    the tests).

    metrics: {"loss", "lr", "grad_norm"} as 0-dim tensors, and the host
    seconds (the card synchronised) of the step's three parts:
    ``gather_s``, ``compute_s`` (the label counts, forward and backward,
    the products' exchanges along ``"model"`` included) and ``reduce_s``
    (gradients, norm and AdamW)."""
    specs = params_shardings(model.cfg, dict(model.named_parameters()), mesh,
                             rules)
    ndims = reference_ndims(model)
    wide = torch.promote_types(model.dtype, torch.float32)
    experts = _expert_leaves(model, mesh, specs)
    cuts = {n: c if partitioned else ModelCut(None, "whole")
            for n, c in model_cuts(model.cfg, specs, mesh).items()
            if n not in experts}
    rest = tuple(a for a in mesh.axis_names if a != "model")

    def step(params, opt_state, batch):
        own = dict(model.named_parameters())
        whole = [n for n in own if n not in experts
                 and cuts[n].mode != "cut"]
        t0 = _clock(model.device)
        with torch.no_grad():
            for name in whole:
                own[name].copy_(gather_full(params[name], specs[name], mesh))
            # the rank's "model" cut, whole along the batch's axes
            local_leaves = {n: gather_full(params[n], specs[n], mesh, rest)
                            for n, c in cuts.items() if c.mode == "cut"}
        t1 = _clock(model.device)
        parts = _split(batch, microbatches) if microbatches > 1 else [batch]
        cut = batch_shardings(parts[0], mesh, rules)
        local = [{k: shard_of(x, cut[k], mesh) for k, x in part.items()}
                 for part in parts]
        red = _axes(cut["labels"][0] if cut["labels"] else None)
        for n in experts:
            if _axes(specs[n][1] if len(specs[n]) > 1 else None) \
                    not in ((), red):
                raise NotImplementedError(
                    f"{n}: its rows are cut over {specs[n][1]}, the batch "
                    f"over {red}; the layer sums the block's gradient over "
                    f"the batch's axes")
        counts = torch.stack([torch.sum(b["labels"] >= 0) for b in local]
                             ).to(wide)
        weights = (torch.full_like(counts, 1.0 / mesh.size(red))
                   if mean_of_means else
                   counts / torch.clamp(mesh.all_reduce(counts, red),
                                        min=1.0))
        loss, grads = None, None
        for w, part in zip(weights, local):
            # the weight scales the loss before the backward, whose
            # collectives sum the expert blocks' gradients over the ranks
            blocks = {n: params[n].detach().requires_grad_()
                      for n in experts}
            mine = {n: x.detach().requires_grad_()
                    for n, x in local_leaves.items()}
            by_module = {}
            for n, (module, key) in experts.items():
                by_module.setdefault(module, {})[key] = blocks[n]
            with moe.training_blocks(by_module.items(), red), \
                    tensor_parallel.cuts(mesh, {id(own[n]): x
                                                for n, x in mine.items()}):
                l = model.loss(part).to(wide) * (w / microbatches)
            wrt = {**{n: own[n] for n in whole}, **mine, **blocks}
            g = torch.autograd.grad(l, list(wrt.values()), allow_unused=True,
                                    materialize_grads=True)
            g = dict(zip(wrt, g))
            del blocks, mine, wrt
            if grads is None:
                loss = l.detach()
                grads = {n: x.to(wide) for n, x in g.items()}
            else:
                loss = loss + l.detach()
                for n, x in g.items():
                    grads[n] += x
            del g
        del local_leaves
        t2 = _clock(model.device)
        loss = mesh.all_reduce(loss, red)
        partial = red + ("model",) if sum_partial else red
        out = {}
        for name in list(grads):
            g = grads.pop(name)
            if name in experts:      # the block's, summed in the backward
                out[name] = g
                continue
            mode = cuts[name].mode
            full = mesh.all_reduce(g, partial if mode == "partial" else red)
            out[name] = shard_of(full, specs[name], mesh,
                                 rest if mode == "cut" else None)
            del full, g
        new_params, new_state, metrics = apply_updates(
            params, out, opt_state, opt_cfg, ndims, mesh=mesh,
            specs=specs)
        t3 = _clock(model.device)
        metrics.update(loss=loss, gather_s=t1 - t0, compute_s=t2 - t1,
                       reduce_s=t3 - t2)
        return new_params, new_state, metrics

    step.specs = specs
    step.cuts = cuts
    return step


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names as a tuple (() for None)."""
    if not entry:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _expert_leaves(model: LM, mesh, specs) -> Dict[str, Tuple[Any, str]]:
    """{name: (its MoE module, "w1" / "w3" / "w2")} of every expert weight
    the layer runs expert parallelism on under ``mesh``: the leaves the
    step keeps as blocks."""
    if not moe.expert_parallel(model.cfg, mesh):
        return {}
    out = {}
    for name in specs:
        head, _, key = name.rpartition(".")
        if key in ("w1", "w3", "w2") and head.endswith(".moe"):
            if _axes(specs[name][0] if specs[name] else None) != ("model",):
                raise NotImplementedError(
                    f"{name}: expert parallelism needs the experts over "
                    f"'model', the spec is {specs[name]}")
            out[name] = (model.get_submodule(head), key)
    return out


class _Shaped(tuple):
    """A leaf's shape where `cache_shardings` reads ``.shape`` and
    ``.ndim``."""

    @property
    def shape(self):
        return tuple(self)

    @property
    def ndim(self):
        return len(self)


class _ServeLayout:
    """What the sharded serving steps of ``model`` on ``mesh`` share: each
    parameter's spec, how the steps compute with it along ``"model"``,
    and the rank's placement of the parameters in ``model`` (made once per
    model and set of blocks: the prefill and decode steps of one model
    share it)."""

    def __init__(self, model: LM, mesh, rules: Dict[str, Any]):
        cfg = model.cfg
        if cfg.mla is not None or cfg.encoder is not None or any(
                b.kind != "attn" for b in model.blocks):
            raise NotImplementedError(
                "sharded serving covers GQA self-attention configs; MLA's "
                "latent cache, the Mamba state and cross-attention wait "
                "for a later slice")
        self.model, self.mesh, self.rules = model, mesh, rules
        placed = getattr(model, "_sharded_serve", None)
        #: the parameters' whole shapes (meta), before any placement
        self.full = placed["full"] if placed else {
            n: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for n, p in model.named_parameters()}
        self.specs = params_shardings(cfg, self.full, mesh, rules)
        self.cuts = model_cuts(cfg, self.specs, mesh, serving=True)
        self.experts = set(_expert_leaves(model, mesh, self.specs))
        self.rest = tuple(a for a in mesh.axis_names if a != "model")

    def cache_specs(self, batch_size: int, s_max: int) -> Dict[str, Any]:
        """`cache_shardings` of the whole cache of ``batch_size`` rows of
        ``s_max`` (from its shapes: nothing is made)."""
        cfg = self.model.cfg
        kv = _Shaped((batch_size, s_max, cfg.n_kv_heads, cfg.head_dim))
        whole = {"layers": [{"k": kv, "v": kv, "len": 0}
                            for _ in self.model.blocks], "enc_out": None}
        return cache_shardings(whole, self.mesh, self.rules)

    def place(self, params: Dict[str, Tensor]) -> float:
        """Put this rank's parameters in the model from its blocks
        ``params``, unless these blocks are placed already: each leaf the
        steps compute on its ``"model"`` cut, and each expert block,
        gathered over the other axes only; every other leaf whole.  Host
        seconds it took (0.0 when placed already)."""
        model = self.model
        key = (id(self.mesh), tuple(id(t) for t in params.values()))
        placed = getattr(model, "_sharded_serve", None)
        if placed is not None and placed["key"] == key:
            return 0.0
        if params.keys() != self.full.keys():
            raise KeyError(f"parameter names differ from the model's: "
                           f"{sorted(set(params) ^ set(self.full))}")
        t0 = _clock(next(iter(params.values())).device)
        sel = {}
        with torch.no_grad():
            for name, blk in params.items():
                mine = name in self.experts or self.cuts[name].mode == "cut"
                t = gather_full(blk, self.specs[name], self.mesh,
                                self.rest if mine else None)
                head, _, leaf = name.rpartition(".")
                module = model.get_submodule(head) if head else model
                module._parameters[leaf] = p = torch.nn.Parameter(
                    t, requires_grad=False)
                if mine or leaf == "router":
                    sel[id(p)] = p
        model._sharded_serve = dict(key=key, full=self.full, selection=sel)
        return _clock(t.device) - t0

    @contextlib.contextmanager
    def selected(self, batch_axes: Tuple[str, ...]):
        """The rank's products for the block: its placed cuts selected as
        their own blocks (`models.tensor_parallel.cuts`), the mesh and
        rules installed, no gradient."""
        sel = self.model._sharded_serve["selection"]
        with torch.no_grad(), use_mesh(self.mesh, self.rules), \
                tensor_parallel.cuts(self.mesh, sel, batch_axes):
            yield

    def local_batch(self, batch: Dict[str, Tensor]
                    ) -> Tuple[Dict[str, Tensor], Tuple[str, ...]]:
        """This rank's cut of the global ``batch`` (`batch_shardings`) and
        the axes its batch is cut over."""
        cut = batch_shardings(batch, self.mesh, self.rules)
        key = "embeds" if "embeds" in batch else "tokens"
        return ({k: shard_of(x, cut[k], self.mesh) for k, x in batch.items()},
                _axes(cut[key][0] if cut[key] else None))


def _serve_step(layout: _ServeLayout, step: Callable) -> Callable:
    step.specs = layout.specs
    step.cuts = layout.cuts
    step.cache_specs = layout.cache_specs
    step.metrics = {}
    return step


def make_sharded_prefill_step(model: LM, s_max: int, mesh,
                              rules: Dict[str, Any]) -> Callable:
    """(param blocks, global batch) -> (this rank's cache blocks, the last
    position's logits (B / data, vocab) for the rank's cut of the batch),
    called by every rank of ``mesh``: the reference's prefill step jitted
    under `params_shardings` and `cache_shardings` (``rules``:
    `arch_rules(cfg, mesh, "prefill")`).  GQA self-attention configs only
    (with MoE layers too: dbrx).

    At its first call with a set of blocks the rank places its parameters
    in ``model`` once (serving updates nothing): each leaf the rules cut
    over ``"model"`` in a module that computes on the cut
    (`model_cuts(..., serving=True)`: GQA attention, dense MLPs,
    vocabulary) and each expert block, gathered over the batch's axes
    only, so no whole copy of such a leaf is placed; every other leaf
    whole.  ``model`` may be built on meta.  The rank's cache blocks
    (`LM.init_cache` with the mesh) start empty; the prompt's attention
    runs on the rank's heads over its own k and v, and each rank writes
    the rows of its sequence segment (`models.attention`).

    ``.specs``, ``.cuts``, ``.cache_specs(batch_size, s_max)``; after a
    call ``.metrics``: host seconds (the card synchronised) of the call
    (``prefill_s``), inside the mesh's collectives (``exchange_s``), the
    rest (``compute_s``) and of the placement (``place_s``)."""
    layout = _ServeLayout(model, mesh, rules)

    def step(params, batch):
        place_s = layout.place(params)
        ex0 = mesh.exchange_s
        t0 = _clock(model.device)
        local, axes = layout.local_batch(batch)
        inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
        b = inp.shape[0]
        cache = model.init_cache(b, s_max, mesh=mesh,
                                 specs=layout.cache_specs(b, s_max))
        with layout.selected(axes):
            cache, logits = model.prefill(local, s_max, cache=cache)
        total = _clock(model.device) - t0
        ex = mesh.exchange_s - ex0
        step.metrics = dict(prefill_s=total, exchange_s=ex,
                            compute_s=total - ex, place_s=place_s)
        return cache, logits

    return _serve_step(layout, step)


def make_sharded_decode_step(model: LM, mesh, rules: Dict[str, Any]
                             ) -> Callable:
    """(param blocks, this rank's cache blocks, global batch of one token)
    -> (the cache, the logits (B / data, vocab) of the rank's cut of the
    batch), called by every rank of ``mesh``: the reference's decode step
    jitted under its shardings (``rules``: `arch_rules(cfg, mesh,
    "decode")`).  The parameters are placed as
    `make_sharded_prefill_step` places them (once per model and blocks:
    a decode step made on the prefill step's model uses its placement).

    Each attention layer gathers the new token's q to every head, attends
    over the rank's segment of the cache through the flash kernel's
    decode body with each row's log-sum-exp, and combines the ranks'
    partials (`launch.mesh.combine_partials`, one a layer); the rank that
    owns row ``len`` writes the token's k and v.  ``len`` stays global.
    ``.specs``, ``.cuts``, ``.cache_specs``; ``.metrics`` as the prefill
    step's, with ``decode_s``."""
    layout = _ServeLayout(model, mesh, rules)

    def step(params, cache, batch):
        place_s = layout.place(params)
        ex0 = mesh.exchange_s
        t0 = _clock(model.device)
        local, axes = layout.local_batch(batch)
        with layout.selected(axes):
            cache, logits = model.decode_step(cache, local)
        total = _clock(model.device) - t0
        ex = mesh.exchange_s - ex0
        step.metrics = dict(decode_s=total, exchange_s=ex,
                            compute_s=total - ex, place_s=place_s)
        return cache, logits

    return _serve_step(layout, step)


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
