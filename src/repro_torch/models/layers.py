"""Shared layers: initialisers and norms.

Port of the parts of `repro.models.layers` that the Mamba-2 serving path
uses.  Initialisers draw from an explicit ``torch.Generator`` with the
reference's distributions (its `jax.random` bits are not reproducible here:
the parity tests carry the reference's weights across with
`repro_torch.convert.lm_params_from_reference`).  Norms compute in f32 and
cast back to the input's dtype, as the reference does.  The MLP, RoPE and
the chunked cross-entropy port with the slices that run them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None) -> Tensor:
    """(d_in, d_out) weight, N(0, 1) * scale (default d_in ** -0.5), drawn in
    f32 on the generator's device and cast to ``dtype``."""
    scale = (d_in ** -0.5) if scale is None else scale
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def layernorm(x: Tensor, weight: Tensor, bias: Optional[Tensor],
              eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def norm(x: Tensor, params: nn.ParameterDict, kind: str, eps: float
         ) -> Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["w"], eps)
    return layernorm(x, params["w"], params.get("b"), eps)


def norm_init(d: int, kind: str, dtype=torch.float32,
              device="cuda") -> nn.ParameterDict:
    p = {"w": nn.Parameter(torch.ones((d,), dtype=dtype, device=device))}
    if kind == "layernorm":
        p["b"] = nn.Parameter(torch.zeros((d,), dtype=dtype, device=device))
    return nn.ParameterDict(p)
