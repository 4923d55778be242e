"""Unified LM API: init / loss / prefill / decode_step.

Port of `repro.models.model`, as an ``nn.Module`` that holds its weights
(the reference passes an explicit parameter pytree).  It serves and trains
every family of the reference: dense attention (gemma_2b and the other
GQA/MQA configs with RoPE), M-RoPE with embedding inputs (qwen2_vl), the
encoder-decoder with learned positions (whisper), SSM (mamba2_780m), MoE
(dbrx), MLA with MoE (deepseek_v3) and the hybrid of attention, SSM and
MoE (jamba): input embedding, the block loop, the final norm and the tied
(or separate) head, with f32 logits (f64 for an f64 model).  The blocks'
MoE aux losses are summed as the reference's `_backbone` does; `loss` adds
them to the chunked cross-entropy, serving drops them.  In the sharded
train step the embedding lookup and the loss are vocab-parallel where the
step cut the table over ``"model"`` (`models.tensor_parallel`).

Batch dict contract (the reference's):
  tokens     (B, S) integer ids       -- unless ``embeds`` is given
  embeds     (B, S, d)                -- embedding inputs (embeds_input)
  labels     (B, S), -100 masked      -- `loss` only
  frames     (B, n_frames, d)         -- the encoder's input (whisper)
  positions3 (3, B, S) integers       -- M-RoPE's ids (optional)
An embeds_input model given only ``tokens`` embeds them from its table;
its batch size comes from whichever of the two the batch holds (the
reference reads ``embeds`` there and raises without it).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import make_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.layers import (chunked_softmax_xent, embed_init,
                                       embed_lookup, norm, norm_init, upcast)
from repro_torch.models.mamba import make_ssm_cache
from repro_torch.models.transformer import (Block, layer_sigs, plan_stages,
                                            remat)
from repro_torch.sharding import hint

#: the encoder's blocks: attention and a dense channel
ENC_SIG = ("attn", False)

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
        if cfg.pos_emb == "learned":
            self.pos_embed = nn.Parameter(embed_init(gen, cfg.max_seq_len,
                                                     cfg.d_model, dt))
        enc = cfg.encoder
        self.blocks = nn.ModuleList(Block(cfg, sig, gen, dt,
                                          cross=enc is not None)
                                    for sig in layer_sigs(cfg))
        if enc is not None:
            # same widths as the decoder; non-causal attention blocks
            self.enc_blocks = nn.ModuleList(
                Block(cfg, ENC_SIG, gen, dt) for _ in range(enc.n_layers))
            self.enc_norm = norm_init(cfg.d_model, cfg.norm, dt, device)
            self.enc_pos = nn.Parameter(embed_init(gen, enc.n_frames,
                                                   cfg.d_model, dt))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------------------------------------------- embed
    def _embed_in(self, batch: Dict[str, Tensor], cache_len: int = 0
                  ) -> Tensor:
        cfg = self.cfg
        if cfg.embeds_input and "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            # vocab-parallel where the sharded train step cut the table
            x = embed_lookup(tp.block(self.embed), batch["tokens"],
                             tp.mesh_of(self.embed))
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        if cfg.pos_emb == "learned":
            s = x.shape[1]
            if cache_len + s > cfg.max_seq_len:
                raise ValueError(f"positions [{cache_len}, {cache_len + s}) "
                                 f"past max_seq_len {cfg.max_seq_len}")
            x = x + self.pos_embed[cache_len:cache_len + s]
        return hint(x, "batch", "act_seq", "embed")

    def _encode(self, frames: Tensor) -> Tensor:
        """The encoder: frames (B, F, d) plus learned positions through the
        non-causal blocks, then its norm."""
        cfg = self.cfg
        x = frames.to(self.dtype) + self.enc_pos[None, :frames.shape[1]]
        for block in self.enc_blocks:
            x, _, _ = remat(block, self.remat_policy)(
                x, None, use_kernel=self.use_kernel, impl=self.attn_impl,
                causal=False)
        return norm(x, self.enc_norm, cfg.norm, cfg.norm_eps)

    # --------------------------------------------------------------- forward
    def _backbone(self, x: Tensor, *, caches: Optional[List[dict]],
                  enc_out: Optional[Tensor] = None,
                  positions3: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Optional[List[dict]], Optional[Tensor]]:
        """(final-normed hidden, new caches, the MoE blocks' aux loss; None
        where no block has MoE)."""
        aux = None
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.blocks):
            x, nc, a = remat(block, self.remat_policy)(
                x, caches[i] if caches is not None else None,
                use_kernel=self.use_kernel, impl=self.attn_impl,
                enc_out=enc_out, positions3=positions3)
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
        """The last position's f32 logits (B, vocab).  Where a sharded
        serving step cut the head over ``"model"`` (`tensor_parallel`),
        the rank's vocabulary slice, all-gathered over ``"model"``."""
        w = self.embed if self.cfg.tie_embeddings else self.lm_head
        mesh = tp.mesh_of(w)
        if mesh is None:
            return upcast(h[:, -1]) @ upcast(self._head())
        part = upcast(h[:, -1]) @ upcast(tp.block(w).T)    # (B, V_loc)
        return mesh.all_gather(part.T.contiguous(), "model").T

    # ------------------------------------------------------------------ loss
    def _enc_out(self, batch: Dict[str, Tensor]) -> Optional[Tensor]:
        return (self._encode(batch["frames"])
                if self.cfg.encoder is not None else None)

    def loss(self, batch: Dict[str, Tensor]) -> Tensor:
        """Mean next-token CE over ``batch["labels"]`` (-100 masked), plus
        the MoE blocks' aux loss where the model has MoE."""
        h, _, aux = self._backbone(self._embed_in(batch), caches=None,
                                   enc_out=self._enc_out(batch),
                                   positions3=batch.get("positions3"))
        # the rank's vocabulary slice where the sharded train step cut it
        w = self.embed if self.cfg.tie_embeddings else self.lm_head
        ce = chunked_softmax_xent(h, tp.block(w).T, batch["labels"],
                                  chunk=self.loss_chunk,
                                  logit_softcap=self.cfg.logit_softcap,
                                  mesh=tp.mesh_of(w))
        return ce if aux is None else ce + aux

    # --------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, s_max: int, *, device=None,
                   mesh=None, specs=None) -> Dict[str, Any]:
        """One cache per layer: a KV cache of ``s_max`` rows for each
        attention layer, the conv window and SSM state for each SSM layer;
        and ``enc_out``, the encoder's output, which `prefill` fills.
        With ``mesh``, this rank's blocks of the KV caches of a global
        batch of ``batch_size`` under ``specs`` (`launch.shardings.
        cache_shardings`' structure; attention layers only)."""
        device = self.device if device is None else device
        if mesh is not None:
            if any(block.kind != "attn" for block in self.blocks):
                raise NotImplementedError("the SSM state is not cut on a "
                                          "mesh yet")
            return {"layers": [
                make_kv_cache(self.cfg, batch_size, s_max, self.dtype,
                              device, mesh=mesh, spec=spec["k"])
                for spec in specs["layers"]], "enc_out": None}
        return {"layers": [
            make_kv_cache(self.cfg, batch_size, s_max, self.dtype,
                          device) if block.kind == "attn" else
            make_ssm_cache(self.cfg, batch_size, self.dtype, device)
            for block in self.blocks], "enc_out": None}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Tensor], s_max: int,
                cache: Optional[Dict[str, Any]] = None
                ) -> Tuple[Dict[str, Any], Tensor]:
        """Run the full prompt, fill caches, return (cache, last logits).
        ``cache``: empty caches to fill (a sharded serving step's blocks,
        `init_cache` with a mesh), else made here."""
        inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
        if cache is None:
            cache = self.init_cache(inp.shape[0], s_max)
        cache["enc_out"] = self._enc_out(batch)
        h, cache["layers"], _ = self._backbone(
            self._embed_in(batch), caches=cache["layers"],
            enc_out=cache["enc_out"], positions3=batch.get("positions3"))
        return cache, self._logits(h)

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, Any], batch: Dict[str, Tensor]
                    ) -> Tuple[Dict[str, Any], Tensor]:
        """One token: batch['tokens'] (B, 1) (or ``embeds`` (B, 1, d)),
        with its ``positions3`` (3, B, 1) where the model takes them."""
        x = self._embed_in(batch, cache["layers"][0]["len"])
        h, cache["layers"], _ = self._backbone(
            x, caches=cache["layers"], enc_out=cache.get("enc_out"),
            positions3=batch.get("positions3"))
        logits = self._logits(h)
        if self.cfg.logit_softcap > 0:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return cache, logits


def build_model(cfg: ModelConfig, **kw) -> LM:
    return LM(cfg, **kw)
