"""Model assembly: blocks grouped into stages, run as a loop over layers.

Port of `repro.models.transformer`.  `plan_stages` groups the layer
schedule exactly as the reference does; the reference scans each stage over
stacked parameters, while the port keeps one :class:`Block` per layer in a
``ModuleList`` (in layer order: stage by stage, repeat by repeat, sub-layer
by sub-layer) and loops over it, since torch has no scan.

Block = token mixer + channel mixer with pre-norm residuals.  This slice
ports the Mamba-2 mixer with no channel mixer (mamba2_780m); attention,
MoE, dense MLPs and cross-attention raise until their slices port them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norm, norm_init
from repro_torch.models.mamba import Mamba2

Tensor = torch.Tensor

Sig = Tuple[str, bool]  # (kind: "attn"|"ssm", is_moe)


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
    """Pre-norm residual block: x + mixer(norm(x))."""

    def __init__(self, cfg: ModelConfig, sig: Sig, gen: torch.Generator,
                 dtype):
        super().__init__()
        kind, is_moe = sig
        if kind != "ssm":
            raise NotImplementedError("attention blocks port with the "
                                      "flash_attention slice")
        if is_moe:
            raise NotImplementedError("MoE blocks port with the MoE slice")
        if cfg.d_ff > 0:
            raise NotImplementedError("dense MLP blocks port with the "
                                      "attention slice")
        self.cfg = cfg
        self.ln1 = norm_init(cfg.d_model, cfg.norm, dtype, gen.device)
        self.ssm = Mamba2(cfg, gen, dtype)

    def forward(self, x: Tensor, cache: Optional[dict] = None, *,
                use_kernel: Optional[bool] = None
                ) -> Tuple[Tensor, Optional[dict]]:
        h = norm(x, self.ln1, self.cfg.norm, self.cfg.norm_eps)
        mix, new_cache = self.ssm(h, cache, use_kernel=use_kernel)
        return x + mix, new_cache
