"""Model assembly: blocks grouped into stages, run as a loop over layers.

Port of `repro.models.transformer`.  `plan_stages` groups the layer
schedule exactly as the reference does; the reference scans each stage over
stacked parameters, while the port keeps one :class:`Block` per layer in a
``ModuleList`` (in layer order: stage by stage, repeat by repeat, sub-layer
by sub-layer) and loops over it, since torch has no scan.

Block = token mixer (GQA/MQA attention | Mamba-2 SSD) + channel mixer
(dense MLP | MoE | none) with pre-norm residuals, or the parallel residual
(command-r); a decoder block of an encoder-decoder model (whisper) adds
cross-attention over the encoder's output between the two.  A block
returns its MoE aux loss beside its output (None for a dense channel,
which adds nothing), summed over the layers as the reference's
`stage_forward` does.  The encoder's blocks run with ``causal=False``.

Training: `remat` wraps a block in the reference's rematerialisation
policies (`torch.utils.checkpoint`), and `grad_barrier` is the identity.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_init, norm, norm_init
from repro_torch.models.mamba import Mamba2
from repro_torch.models.moe import moe_ffn, moe_init
from repro_torch.sharding import hint

Tensor = torch.Tensor

Sig = Tuple[str, bool]  # (kind: "attn"|"ssm", is_moe)

REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")


def grad_barrier(x: Tensor) -> Tensor:
    """The identity.  The reference's barrier stops XLA from hoisting the
    norm's f32 upcast into a scan's carry buffer and from CSE across the
    backward scan (an `optimization_barrier` with an identity gradient);
    eager PyTorch does no CSE or hoisting, so there is nothing to stop."""
    return x


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_SAVED_OPS = {"dots": _MM + (torch.ops.aten.bmm.default,),
              "dots_no_batch": _MM}


def _save_ops_policy(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the reference's remat policy (`transformer._remat`):
    "none" = as it is; "full" = checkpointed, everything recomputed in
    backward; "dots" = checkpointed, the matmul outputs (``aten.mm``,
    ``addmm``, ``bmm``) saved and the rest recomputed; "dots_no_batch" =
    the same without ``bmm``, the products with batch dims (jax's
    `checkpoint_dots_with_no_batch_dims`).  Outside grad mode ``fn`` runs
    as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {REMAT_POLICIES}")
    if policy == "none":
        return fn
    kw = {}
    if policy in _SAVED_OPS:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_ops_policy, _SAVED_OPS[policy]))

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)
    return run


def plan_stages(cfg: ModelConfig) -> List[Tuple[List[Sig], int]]:
    """[(sub-layer signatures, repeats)]: each stage runs `repeats` times,
    each time applying the listed sub-layers in order."""
    sigs: List[Sig] = [(cfg.layer_kind(i), cfg.layer_is_moe(i))
                       for i in range(cfg.n_layers)]
    runs: List[Tuple[Sig, int]] = []
    for s in sigs:
        if runs and runs[-1][0] == s:
            runs[-1] = (s, runs[-1][1] + 1)
        else:
            runs.append((s, 1))
    if len(runs) <= 4:
        return [([s], c) for s, c in runs]
    # periodic super-block (jamba): smallest q with sig[i] == sig[i % q]
    for q in range(2, cfg.n_layers + 1):
        if cfg.n_layers % q == 0 and all(
                sigs[i] == sigs[i % q] for i in range(cfg.n_layers)):
            return [(sigs[:q], cfg.n_layers // q)]
    return [([s], c) for s, c in runs]


def layer_sigs(cfg: ModelConfig) -> List[Sig]:
    """The signature of every layer, in the order the stages run them."""
    return [sig for sigs, reps in plan_stages(cfg) for _ in range(reps)
            for sig in sigs]


class Block(nn.Module):
    """Pre-norm residual block (`block_init` + `block_forward` of the
    reference): x + mixer(norm(x)), then + cross(norm(x), enc_out) in a
    decoder block with ``cross``, then + channel(norm(x)) where the
    config has a channel (a dense MLP, or MoE on the layers the config
    marks); or x + mixer(h) + channel(h) on the same h = norm(x) with the
    parallel residual."""

    def __init__(self, cfg: ModelConfig, sig: Sig, gen: torch.Generator,
                 dtype, cross: bool = False):
        super().__init__()
        kind, is_moe = sig
        self.cfg = cfg
        self.kind = kind
        self.is_moe = is_moe
        dev = gen.device
        self.ln1 = norm_init(cfg.d_model, cfg.norm, dtype, dev)
        if kind == "attn":
            self.attn = attn_mod.attn_init(gen, cfg, dtype)
        else:
            self.ssm = Mamba2(cfg, gen, dtype)
        if cross:
            self.ln_cross = norm_init(cfg.d_model, cfg.norm, dtype, dev)
            self.cross = attn_mod.cross_attn_init(gen, cfg, dtype)
        self.has_cross = cross
        self.has_mlp = not is_moe and cfg.d_ff > 0
        if is_moe or self.has_mlp:
            self.ln2 = norm_init(cfg.d_model, cfg.norm, dtype, dev)
        if is_moe:
            self.moe = moe_init(gen, cfg, dtype)
        elif self.has_mlp:
            self.mlp = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                dtype, bias=cfg.mlp_bias)

    def _channel(self, h: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        """(channel output, MoE aux loss or None)."""
        if self.is_moe:
            return moe_ffn(self.moe, h, self.cfg)
        if self.has_mlp:
            return mlp_apply(h, self.mlp, self.cfg.mlp_act), None
        return torch.zeros_like(h), None

    def forward(self, x: Tensor, cache: Optional[dict] = None, *,
                use_kernel: Optional[bool] = None, impl: str = "chunked",
                enc_out: Optional[Tensor] = None,
                positions3: Optional[Tensor] = None, causal: bool = True
                ) -> Tuple[Tensor, Optional[dict], Optional[Tensor]]:
        """(x', cache', MoE aux loss or None).  ``use_kernel`` goes to the
        mixers (None: their kernels on CUDA); ``impl`` is the attention
        path without the kernel ("ref" or "chunked"); ``enc_out`` is what a
        cross block attends to; ``positions3`` M-RoPE's ids; ``causal``
        False in the encoder."""
        cfg = self.cfg
        h = norm(x, self.ln1, cfg.norm, cfg.norm_eps)
        if self.kind == "attn":
            mix, new_cache = attn_mod.attn_forward(
                self.attn, h, cfg, causal=causal, cache=cache,
                positions3=positions3, impl=impl, use_kernel=use_kernel)
        else:
            mix, new_cache = self.ssm(h, cache, use_kernel=use_kernel)
        aux = None
        if cfg.parallel_residual:
            out, aux = self._channel(h)
            x = x + mix + out
        else:
            x = x + mix
            if self.has_cross:
                hc = norm(x, self.ln_cross, cfg.norm, cfg.norm_eps)
                x = x + attn_mod.cross_attn_forward(
                    self.cross, hc, enc_out, cfg, impl=impl,
                    use_kernel=use_kernel)
            if self.is_moe or self.has_mlp:
                out, aux = self._channel(norm(x, self.ln2, cfg.norm,
                                              cfg.norm_eps))
                x = x + out
        return hint(x, "batch", "act_seq", "embed"), new_cache, aux
