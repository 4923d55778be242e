"""Shared layers: initialisers, norms, the dense MLP and RoPE.

Port of the parts of `repro.models.layers` that the serving paths use.
Initialisers draw from an explicit ``torch.Generator`` with the reference's
distributions (its `jax.random` bits are not reproducible here: the parity
tests carry the reference's weights across with
`repro_torch.convert.lm_params_from_reference`).  Norms compute in f32 and
cast back to the input's dtype, as the reference does.  RoPE and M-RoPE
rotate interleaved pairs (``x[..., ::2]``, ``x[..., 1::2]``) with angles in
f32, as the reference does.  The chunked cross-entropy
recomputes each chunk's f32 logits in backward, as the reference's
`jax.checkpoint` does.  In the sharded train step the MLP, the embedding
lookup and the cross-entropy compute on the rank's ``"model"`` cut
(`models.tensor_parallel`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tensor_parallel as tp

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


def upcast(x: Tensor) -> Tensor:
    """``x`` in f32, or as it is where it is wider (f64): the compute dtype
    of the norms, the attention math and the loss, so an f64 model (the
    card's f32-against-f64 checks) computes in f64 throughout."""
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * upcast(weight)
    return out.to(x.dtype)


def layernorm(x: Tensor, weight: Tensor, bias: Optional[Tensor],
              eps: float = 1e-5) -> Tensor:
    xf = upcast(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * upcast(weight)
    if bias is not None:
        out = out + upcast(bias)
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
    optional biases b1, b2).  Where the sharded train step cut the layer
    over ``"model"`` (`tensor_parallel.cuts`), ``w1`` / ``w3`` / ``b1``
    are the rank's columns and ``w2`` its rows: the partial output is
    summed over ``"model"`` before ``b2``, which is added once."""
    mesh = tp.mesh_of(params["w1"])
    p = {k: tp.block(v) for k, v in params.items()}
    if mesh is not None:
        x = mesh_lib.sum_grad(x, mesh, "model")      # column products' input
    if act in ("swiglu", "geglu"):
        g = x @ p["w1"]
        u = x @ p["w3"]
        h = (F.silu(g) if act == "swiglu" else
             F.gelu(g, approximate="tanh")) * u
        out = h @ p["w2"]
    else:
        h = x @ p["w1"]
        if "b1" in p:
            h = h + p["b1"]
        h = F.gelu(h, approximate="tanh")
        out = h @ p["w2"]
    if mesh is not None:                             # the row product's sum
        out = mesh_lib.all_reduce_grad(out, mesh, "model", ())
    if "b2" in p:
        out = out + p["b2"]
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
# rotary position embeddings (RoPE / partial RoPE / M-RoPE)
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


def mrope_apply(x: Tensor, positions3: Tensor, theta: float,
                sections: Tuple[int, ...]) -> Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions3: (3, B, S)
    temporal, height and width ids.  ``sections`` splits the half-dim
    frequency bands among the three axes (band i takes its positions from
    ``positions3[i]``), so ``sum(sections)`` must be D / 2.  Interleaved
    pairs, angles in f32, the result in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} sum to "
                         f"{sum(sections)}, not head_dim / 2 = {half}")
    freqs = _rope_freqs(d, theta, x.device)               # (half,)
    band_axis = torch.cat([torch.full((s,), i, dtype=torch.long)
                           for i, s in enumerate(sections)]).to(x.device)
    # positions per element of the half-dim: (B, S, half)
    pos = positions3.float()[band_axis].permute(1, 2, 0)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked cross-entropy (bounded logit memory)
# ---------------------------------------------------------------------------

def _vocab_range(width: int, mesh) -> Tuple[int, int]:
    """(first id, count) of the vocabulary slice this rank holds along
    ``"model"`` (``width`` ids a rank)."""
    return mesh.index("model") * width, width


def embed_lookup(table: Tensor, ids: Tensor, mesh=None) -> Tensor:
    """``table[ids]``.  With ``mesh``, ``table`` is this rank's slice of
    the vocabulary along ``"model"`` (vocab-parallel): ids outside it look
    up zeros, and the rows are summed over ``"model"``, the gradient the
    identity (each rank's slice gets its own rows' gradient)."""
    if mesh is None:
        return table[ids]
    lo, n = _vocab_range(table.shape[0], mesh)
    local = ids.long() - lo
    own = (local >= 0) & (local < n)
    rows = torch.where(own[..., None], table[torch.where(own, local, 0)], 0)
    return mesh_lib.all_reduce_grad(rows, mesh, "model", ())


def _xent_chunk(hx: Tensor, emb_out: Tensor, lx: Tensor,
                logit_softcap: float, mesh=None) -> Tuple[Tensor, Tensor]:
    """(summed CE, count of unmasked labels) of one sequence chunk.  With
    ``mesh``, ``emb_out`` is this rank's vocabulary slice along
    ``"model"``: the logits' max and their sum of exponents are reduced
    over ``"model"``, and the target logit comes from the rank that holds
    the label's id."""
    logits = upcast(hx @ emb_out)                         # (B, chunk, vocab)
    if logit_softcap > 0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.take_along_dim(
            logits, torch.clamp(lx, min=0).long()[..., None], dim=-1)[..., 0]
    else:
        top = mesh.all_reduce(logits.detach().amax(dim=-1), "model", "max")
        sumexp = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
        lse = top + torch.log(mesh_lib.all_reduce_grad(sumexp, mesh,
                                                       "model", ()))
        lo, n = _vocab_range(logits.shape[-1], mesh)
        local = lx.long() - lo
        own = (local >= 0) & (local < n)
        tgt = torch.take_along_dim(
            logits, torch.where(own, local, 0)[..., None], dim=-1)[..., 0]
        tgt = mesh_lib.all_reduce_grad(torch.where(own, tgt, 0.0), mesh,
                                       "model", ())
    mask = (lx >= 0).to(logits.dtype)
    return torch.sum((lse - tgt) * mask), torch.sum(mask)


def chunked_softmax_xent(h: Tensor, emb_out: Tensor, labels: Tensor,
                         chunk: int = 4096,
                         logit_softcap: float = 0.0, mesh=None) -> Tensor:
    """Mean next-token CE over (B, S, d) hidden states against the head
    ``emb_out`` (d, vocab), without the full (tokens, vocab) logits: a loop
    over *sequence* chunks whose body is checkpointed, so one chunk's f32
    logits are the only transient and none is saved for backward.  Labels
    of -100 are masked; the target gather clamps them to 0 first, as the
    reference does.

    With ``mesh`` the head is this rank's vocabulary slice along
    ``"model"`` (vocab-parallel, `_xent_chunk`); ``h`` enters through
    `launch.mesh.sum_grad`, as a column product's input."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    dt = upcast(h[:0]).dtype
    tot = torch.zeros((), dtype=dt, device=h.device)
    cnt = torch.zeros((), dtype=dt, device=h.device)
    if mesh is not None:
        h = mesh_lib.sum_grad(h, mesh, "model")
    for lo in range(0, s, chunk):
        args = (h[:, lo:lo + chunk], emb_out, labels[:, lo:lo + chunk],
                logit_softcap, mesh)
        if torch.is_grad_enabled():
            t, c = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            t, c = _xent_chunk(*args)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)
