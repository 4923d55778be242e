"""Unified LM API: init / loss / prefill / decode_step.

Port of `repro.models.model`, as an ``nn.Module`` that holds its weights
(the reference passes an explicit parameter pytree).  It serves and trains
the dense attention family (gemma_2b and the other GQA/MQA configs with
RoPE), the SSM family (mamba2_780m), MoE (dbrx), MLA with MoE (deepseek_v3)
and the hybrid of attention, SSM and MoE (jamba, without positions): token
embedding, the block loop, the final norm and the tied (or separate) head,
with f32 logits (f64 for an f64 model).  The blocks' MoE aux losses are
summed as the reference's `_backbone` does; `loss` adds them to the
chunked cross-entropy, serving drops them.  M-RoPE, the encoder, learned positions and embedding inputs
port with their slices and raise here.  Batches hold ``tokens`` (B, S)
integer ids and, for `loss`, ``labels`` (B, S) with -100 masked.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import make_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_softmax_xent, embed_init,
                                       norm, norm_init, upcast)
from repro_torch.models.mamba import make_ssm_cache
from repro_torch.models.transformer import (Block, layer_sigs, plan_stages,
                                            remat)

Tensor = torch.Tensor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so the initialisers
    (which draw on ``gen.device``) build shapes and dtypes only."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class LM(nn.Module):
    """The model of one config, its weights drawn from a seeded generator.

    ``use_kernel`` goes to every mixer (`ops.ssd`, the attention's
    `_sdpa`): None = the Hopper kernels on CUDA, the plain paths on the CPU;
    True = the kernels' wrappers (their plain versions on the CPU); False =
    the plain paths.  The kernels have no backward, so a model that trains
    takes ``use_kernel=False``.  ``attn_impl`` is the reference's: the
    attention math without the kernel, "ref" (full scores), "chunked"
    (query blocks) or "tri" (diagonal bands).  ``remat_policy`` ("none",
    "full", "dots", "dots_no_batch") and ``loss_chunk`` are the
    reference's training knobs.  ``device="meta"`` builds shapes and
    dtypes only."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 use_kernel: Optional[bool] = None,
                 attn_impl: str = "chunked", remat_policy: str = "full",
                 loss_chunk: int = 4096):
        super().__init__()
        if cfg.encoder is not None:
            raise NotImplementedError("encoder-decoder models port with "
                                      "their slice")
        if cfg.pos_emb in ("learned", "mrope") or cfg.embeds_input:
            raise NotImplementedError("learned positions, M-RoPE and "
                                      "embedding inputs port with their "
                                      "models' slices")
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.attn_impl = attn_impl
        self.remat_policy = remat_policy
        self.loss_chunk = loss_chunk
        self.stages = plan_stages(cfg)
        self.dtype = DTYPES[cfg.dtype]
        gen = (_MetaGenerator() if torch.device(device).type == "meta"
               else torch.Generator(device=device)).manual_seed(seed)
        dt = self.dtype
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, dt))
        self.final_norm = norm_init(cfg.d_model, cfg.norm, dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(embed_init(gen, cfg.vocab_size,
                                                   cfg.d_model, dt))
        self.blocks = nn.ModuleList(Block(cfg, sig, gen, dt)
                                    for sig in layer_sigs(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------------------------------------------- embed
    def _embed_in(self, batch: Dict[str, Tensor]) -> Tensor:
        x = self.embed[batch["tokens"]]
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    # --------------------------------------------------------------- forward
    def _backbone(self, x: Tensor, *, caches: Optional[List[dict]]
                  ) -> Tuple[Tensor, Optional[List[dict]], Optional[Tensor]]:
        """(final-normed hidden, new caches, the MoE blocks' aux loss; None
        where no block has MoE)."""
        aux = None
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.blocks):
            x, nc, a = remat(block, self.remat_policy)(
                x, caches[i] if caches is not None else None,
                use_kernel=self.use_kernel, impl=self.attn_impl)
            if a is not None:
                aux = a if aux is None else aux + a
            if new_caches is not None:
                new_caches.append(nc)
        x = norm(x, self.final_norm, self.cfg.norm, self.cfg.norm_eps)
        return x, new_caches, aux

    def _head(self) -> Tensor:
        w = self.embed if self.cfg.tie_embeddings else self.lm_head
        return w.T  # (d, vocab)

    def _logits(self, h: Tensor) -> Tensor:
        return upcast(h[:, -1]) @ upcast(self._head())

    # ------------------------------------------------------------------ loss
    def loss(self, batch: Dict[str, Tensor]) -> Tensor:
        """Mean next-token CE over ``batch["labels"]`` (-100 masked), plus
        the MoE blocks' aux loss where the model has MoE."""
        h, _, aux = self._backbone(self._embed_in(batch), caches=None)
        ce = chunked_softmax_xent(h, self._head(), batch["labels"],
                                  chunk=self.loss_chunk,
                                  logit_softcap=self.cfg.logit_softcap)
        return ce if aux is None else ce + aux

    # --------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, s_max: int) -> Dict[str, Any]:
        """One cache per layer: a KV cache of ``s_max`` rows for each
        attention layer, the conv window and SSM state for each SSM
        layer."""
        return {"layers": [
            make_kv_cache(self.cfg, batch_size, s_max, self.dtype,
                          self.device) if block.kind == "attn" else
            make_ssm_cache(self.cfg, batch_size, self.dtype, self.device)
            for block in self.blocks]}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Tensor], s_max: int
                ) -> Tuple[Dict[str, Any], Tensor]:
        """Run the full prompt, fill caches, return (cache, last logits)."""
        cache = self.init_cache(batch["tokens"].shape[0], s_max)
        h, cache["layers"], _ = self._backbone(self._embed_in(batch),
                                               caches=cache["layers"])
        return cache, self._logits(h)

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, Any], batch: Dict[str, Tensor]
                    ) -> Tuple[Dict[str, Any], Tensor]:
        """One token: batch['tokens'] (B, 1)."""
        h, cache["layers"], _ = self._backbone(self._embed_in(batch),
                                               caches=cache["layers"])
        logits = self._logits(h)
        if self.cfg.logit_softcap > 0:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return cache, logits


def build_model(cfg: ModelConfig, **kw) -> LM:
    return LM(cfg, **kw)
