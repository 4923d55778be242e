"""Plain-torch oracle for block-wise (flash) attention with GQA.

Port of `repro.kernels.flash_attention.ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  scale: Optional[float] = None) -> Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); Hq % Hkv == 0.  KV heads
    repeat across their query group; the causal mask is
    ``kpos <= qpos + (Skv - Sq)``; f32 softmax, output in q's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq.float()).to(q.dtype)
