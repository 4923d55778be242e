"""Deterministic, resumable data pipeline.

Port of `repro.data.pipeline`.  Restart-exactness is the fault-tolerance
contract: a batch is a pure function of (seed, step), so resuming from a
checkpointed step reproduces the exact token stream with no reader state to
persist.  Two sources:
  * synthetic — a seed-fixed bigram permutation with 20% uniform noise,
    drawn from a CPU ``torch.Generator`` seeded from (seed, step) and then
    moved to the device, so a batch is the same on every device.  It keeps
    the reference's contract, not its stream: `jax.random` bits are not
    reproducible in torch, so parity tests feed both packages one numpy
    batch;
  * memmap — a flat uint16 token file, windows drawn with numpy exactly as
    the reference draws them, so its batches are identical to the
    reference's.

A synthetic batch carries, on request, the inputs of the multimodal
configs as the reference's does: ``embeds`` (B, S, d) f32 in place of
``tokens`` (the labels stay the token stream's), encoder ``frames``
(B, F, d) f32, both N(0, 1) * 0.02 from the same generator, and
``positions3`` (3, B, S), one arange on all three axes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

Tensor = torch.Tensor

#: mixes the step into the generator's seed (a prime, so distinct
#: (seed, step) pairs of a run never share a seed)
_STEP_MIX = 1_000_003


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"          # "synthetic" | "memmap"
    path: Optional[str] = None         # memmap token file (uint16)
    mask_fraction: float = 0.0         # fraction of label positions masked


def _shifted_labels(tokens: Tensor) -> Tensor:
    pad = torch.full((tokens.shape[0], 1), -100, dtype=tokens.dtype)
    return torch.cat([tokens[:, 1:], pad], dim=1)


def synthetic_batch(cfg: DataConfig, step: int, d_model: int = 0,
                    with_embeds: bool = False, with_frames: int = 0,
                    with_positions3: bool = False,
                    device="cuda") -> Dict[str, Tensor]:
    """A pure function of (seed, step) -> {"tokens", "labels"} (B, S) int32
    on ``device``; labels are the tokens shifted by one, -100 last.  With
    ``with_embeds`` the tokens give way to ``embeds`` (B, S, d_model);
    ``with_frames`` = F adds ``frames`` (B, F, d_model); ``with_positions3``
    adds ``positions3`` (3, B, S) int32.

    Tokens follow a seed-fixed bigram permutation with 20% uniform noise: a
    stream with a learnable signal (IID tokens have irreducible loss
    ln(V)), yet a pure function of (seed, step)."""
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    perm = torch.randperm(v, generator=torch.Generator().manual_seed(
        cfg.seed ^ 0x5EED))
    gen = torch.Generator().manual_seed(cfg.seed * _STEP_MIX + step)
    first = torch.randint(0, v, (b,), generator=gen)
    noisy = torch.rand((b, s), generator=gen) < 0.2
    resample = torch.randint(0, v, (b, s), generator=gen)
    cols = [first]
    for t in range(1, s):
        cols.append(torch.where(noisy[:, t], resample[:, t], perm[cols[-1]]))
    tokens = torch.stack(cols, dim=1).to(torch.int32)
    batch = {"tokens": tokens, "labels": _shifted_labels(tokens)}
    if with_embeds:
        batch["embeds"] = torch.randn((b, s, d_model), generator=gen) * 0.02
        del batch["tokens"]
    if with_frames:
        batch["frames"] = torch.randn((b, with_frames, d_model),
                                      generator=gen) * 0.02
    if with_positions3:
        batch["positions3"] = torch.arange(s, dtype=torch.int32).expand(
            3, b, s).contiguous()
    return {k: x.to(device) for k, x in batch.items()}


class MemmapSource:
    """Flat uint16 token file; batch ``step`` reads a deterministic window
    per row (numpy's generator seeded from (seed, step), as the
    reference)."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        if not cfg.path:
            raise ValueError("the memmap source needs cfg.path")
        self.cfg = cfg
        self.device = device
        self.tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        self.n = len(self.tokens)

    def batch(self, step: int) -> Dict[str, Tensor]:
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        rng = np.random.default_rng(cfg.seed * _STEP_MIX + step)
        starts = rng.integers(0, self.n - s - 1, size=b)
        toks = np.stack([self.tokens[st:st + s].astype(np.int32)
                         for st in starts])
        labels = np.stack([self.tokens[st + 1:st + s + 1].astype(np.int32)
                           for st in starts])
        return {"tokens": torch.from_numpy(toks).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}


def make_iterator(cfg: DataConfig, start_step: int = 0, device="cuda",
                  **synthetic_kw) -> Iterator[Dict[str, Tensor]]:
    """Resumable iterator: pass the checkpointed step as ``start_step``."""
    src = MemmapSource(cfg, device) if cfg.source == "memmap" else None
    step = start_step
    while True:
        if src is not None:
            yield src.batch(step)
        else:
            yield synthetic_batch(cfg, step, device=device, **synthetic_kw)
        step += 1


def batch_kwargs_for(cfg_model) -> Dict:
    """`synthetic_batch` kwargs required by a ModelConfig's input
    contract."""
    kw: Dict = {}
    if cfg_model.embeds_input:
        kw.update(with_embeds=True, d_model=cfg_model.d_model)
    if cfg_model.encoder is not None:
        kw.update(with_frames=cfg_model.encoder.n_frames,
                  d_model=cfg_model.d_model)
    if cfg_model.pos_emb == "mrope":
        kw.update(with_positions3=True)
    return kw
