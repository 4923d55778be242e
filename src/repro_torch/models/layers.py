"""Shared layers: initialisers, norms, the dense MLP and RoPE.

Port of the parts of `repro.models.layers` that the serving paths use.
Initialisers draw from an explicit ``torch.Generator`` with the reference's
distributions (its `jax.random` bits are not reproducible here: the parity
tests carry the reference's weights across with
`repro_torch.convert.lm_params_from_reference`).  Norms compute in f32 and
cast back to the input's dtype, as the reference does.  M-RoPE, sinusoidal
positions and the chunked cross-entropy port with the slices that run them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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


# ---------------------------------------------------------------------------
# MLP activations
# ---------------------------------------------------------------------------

def mlp_apply(x: Tensor, params: nn.ParameterDict, act: str) -> Tensor:
    """Gated (swiglu/geglu: w1=gate, w3=up, w2=down) or plain (gelu: w1, w2,
    optional biases b1, b2)."""
    if act in ("swiglu", "geglu"):
        g = x @ params["w1"]
        u = x @ params["w3"]
        h = (F.silu(g) if act == "swiglu" else
             F.gelu(g, approximate="tanh")) * u
        return h @ params["w2"]
    h = x @ params["w1"]
    if "b1" in params:
        h = h + params["b1"]
    h = F.gelu(h, approximate="tanh")
    out = h @ params["w2"]
    if "b2" in params:
        out = out + params["b2"]
    return out


def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype=torch.float32, bias: bool = False) -> nn.ParameterDict:
    if act in ("swiglu", "geglu"):
        names = (("w1", d, d_ff), ("w3", d, d_ff), ("w2", d_ff, d))
    else:
        names = (("w1", d, d_ff), ("w2", d_ff, d))
    p = {n: nn.Parameter(dense_init(gen, i, o, dtype)) for n, i, o in names}
    if bias and act not in ("swiglu", "geglu"):
        p["b1"] = nn.Parameter(torch.zeros((d_ff,), dtype=dtype,
                                           device=gen.device))
        p["b2"] = nn.Parameter(torch.zeros((d,), dtype=dtype,
                                           device=gen.device))
    return nn.ParameterDict(p)


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE / partial RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def rope_apply(x: Tensor, positions: Tensor, theta: float,
               fraction: float = 1.0) -> Tensor:
    """x: (B, S, H, D); positions: (B, S) integers.  Rotates the interleaved
    pairs of the first ``fraction * D`` dims (stablelm partial rotary) in
    f32 and casts them back to x's dtype."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    freqs = _rope_freqs(rot, theta, x.device)             # (rot/2,)
    ang = positions[..., None].float() * freqs            # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)
