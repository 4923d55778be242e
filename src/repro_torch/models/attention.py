"""Attention: GQA/MQA with RoPE and a KV cache, and DeepSeek MLA.

Port of `repro.models.attention`.  Three compute paths for the core
attention, `_sdpa`:
  * the Hopper kernel (`kernels/flash_attention`), on CUDA tensors unless
    ``use_kernel=False``; it reads q and the caches through transposed views
    of their (B, S, H, D) layout, with the valid-prefix length and the
    causal offset as runtime arguments.  It has no backward: a gradient
    through it raises, so training builds its model with
    ``use_kernel=False``, as the reference trains through its jnp math;
  * the reference's ``ref`` / ``chunked`` math in plain torch (full scores,
    or query blocks of `DEFAULT_Q_CHUNK`, each block recomputed in backward
    as the reference's `jax.checkpoint` does): bf16 products summed in f32,
    the softmax in f32 (f64 throughout in an f64 model), p rounded to the
    operands' dtype before p·v.  It takes a value width other than the key
    width (MLA);
  * ``tri``: `_sdpa_tri`, causal square attention in diagonal bands, so
    the blocks above the diagonal are never computed.

Cache contract: dict(k=(B, S_max, Hkv, Dh), v=..., len=int), or for MLA
the latent dict(ckv=(B, S_max, kv_lora), krope=(B, S_max, dr), len=int);
a step of s tokens writes rows [len, len + s) in place (the reference
returns updated copies) and attends to [0, len + s).  Writing past S_max
raises, where the reference's `dynamic_update_slice` would clamp the write.

MLA expands the latent cache per head as the reference's baseline does (no
absorbed matmul) and always runs `_sdpa`'s plain math, as the reference
runs MLA on its jnp math: the kernel takes Dv = D only.

M-RoPE (qwen2-vl) rotates q and k by ``positions3`` (3, B, S); without
them the three axes take the 1-D positions.  Cross-attention (the whisper
decoder) attends, non-causally, to every encoder row; like the reference
it recomputes K and V from the encoder's output at every call, decode
steps included (there is no cross-K/V cache).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, mrope_apply, norm,
                                       norm_init, rope_apply, upcast)
from repro_torch.sharding import hint

Tensor = torch.Tensor

DEFAULT_Q_CHUNK = 256
_NEG = -1e30


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """The reference's MLA parameter tree: ``wq_a`` (d, q_lora),
    ``q_norm``, ``wq_b`` (q_lora, H (dn + dr)), ``wkv_a`` (d, kv_lora + dr),
    ``kv_norm``, ``wkv_b`` (kv_lora, H (dn + dv)) and ``wo`` (H dv, d).
    ``params["wq_a"]`` reads like the reference's dict."""

    def __getitem__(self, name: str):
        return getattr(self, name)


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> MLA:
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    dev = gen.device
    p = MLA()
    p.wq_a = nn.Parameter(dense_init(gen, d, m.q_lora_rank, dtype))
    p.q_norm = norm_init(m.q_lora_rank, "rmsnorm", dtype, dev)
    p.wq_b = nn.Parameter(dense_init(
        gen, m.q_lora_rank, h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
        dtype))
    p.wkv_a = nn.Parameter(dense_init(
        gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype))
    p.kv_norm = norm_init(m.kv_lora_rank, "rmsnorm", dtype, dev)
    p.wkv_b = nn.Parameter(dense_init(
        gen, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim), dtype))
    p.wo = nn.Parameter(dense_init(gen, h * m.v_head_dim, d, dtype))
    return p


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    if cfg.mla is not None:
        return mla_init(gen, cfg, dtype)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, h * hd, dtype),
         "wk": dense_init(gen, d, hkv * hd, dtype),
         "wv": dense_init(gen, d, hkv * hd, dtype),
         "wo": dense_init(gen, h * hd, d, dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def make_kv_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
                  device="cuda") -> dict:
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros((batch, s_max, m.kv_lora_rank),
                                   dtype=dtype, device=device),
                "krope": torch.zeros((batch, s_max, m.qk_rope_head_dim),
                                     dtype=dtype, device=device),
                "len": 0}
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


# ---------------------------------------------------------------------------
# core attention math (q: (B,S,H,D) already rotated)
# ---------------------------------------------------------------------------

def _sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, kv_len: int,
          q_offset: int, scale: float, impl: str, q_chunk: int = 0,
          use_kernel: Optional[bool] = None) -> Tensor:
    """q (B,Sq,H,D); k (B,Skv,Hkv,D); v (B,Skv,Hkv,Dv); kv_len: valid kv
    prefix; q_offset: global position of q[0].  Returns (B,Sq,H,Dv) in q's
    dtype.

    use_kernel: None = the kernel on CUDA tensors, the plain math on CPU
    ones; True = `ops.flash` (the kernel, or its plain version on CPU
    tensors; Dv = D only); False = the plain math: ``impl`` "ref" (full
    scores), "chunked" (query blocks, recomputed in backward) or "tri"
    (`_sdpa_tri`, causal with Sq = Skv; otherwise the chunked math)."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        out = fa_ops.flash(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, scale=scale,
                           kv_valid=kv_len, kv_offset=q_offset)
        return out.transpose(1, 2).reshape(b, sq, hq, dh)
    if impl == "tri" and causal and sq == skv:
        return _sdpa_tri(q, k, v, kv_len=kv_len, scale=scale)
    if q_chunk == 0:
        q_chunk = DEFAULT_Q_CHUNK
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, dh)
    kf, vf = upcast(k), upcast(v)
    kpos = torch.arange(skv, device=q.device)

    def block(qb: Tensor, q_pos: Tensor) -> Tensor:
        # qb (B,bq,Hkv,g,D); scores (B,Hkv,g,bq,Skv)
        s = torch.einsum("bqhgd,bkhd->bhgqk", upcast(qb), kf) * scale
        valid = kpos[None, :] < kv_len
        if causal:
            valid = valid & (kpos[None, :] <= (q_pos + q_offset)[:, None])
        s = torch.where(valid, s, _NEG)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd", upcast(p.to(v.dtype)), vf)

    pos = torch.arange(sq, device=q.device)
    if impl == "ref" or sq <= q_chunk:
        out = block(qg, pos)
    else:
        # never keep a block's (bq, Skv) scores for backward: recompute
        # them per query block (the reference's jax.checkpoint(body))
        run = (lambda *a: checkpoint(block, *a, use_reentrant=False)) \
            if torch.is_grad_enabled() else block
        out = torch.cat([run(qg[:, lo:lo + q_chunk], pos[lo:lo + q_chunk])
                         for lo in range(0, sq, q_chunk)], dim=1)
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def _sdpa_tri(q: Tensor, k: Tensor, v: Tensor, *, kv_len: int,
              scale: float, block: int = 512) -> Tensor:
    """Block-triangular causal attention, Sq = Skv: band d pairs query block
    i with key block i - d for every i >= d in one einsum, so blocks above
    the diagonal are never computed; a streaming softmax merges the bands,
    so score memory stays O(S * block).  The running (m, l, acc) are
    rebuilt by concatenation (not written in place) so autograd sees every
    band."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if sq != skv:
        raise ValueError(f"the triangular path needs square attention, got "
                         f"Sq {sq} and Skv {skv}")
    group = hq // hkv
    pad = (-sq) % block
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    sp = sq + pad
    nb = sp // block
    dev = q.device
    qb = upcast(q.reshape(b, nb, block, hkv, group, dh))
    kb = upcast(k.reshape(b, nb, block, hkv, dh))
    vb = v.reshape(b, nb, block, hkv, dv)
    qb = hint(qb, "batch", None, None, "kv_heads", None, None)
    kb = hint(kb, "batch", None, None, "kv_heads", None)
    vb = hint(vb, "batch", None, None, "kv_heads", None)

    ct = qb.dtype
    m = torch.full((b, nb, block, hkv, group), _NEG, dtype=ct, device=dev)
    l = torch.zeros((b, nb, block, hkv, group), dtype=ct, device=dev)
    acc = torch.zeros((b, nb, block, hkv, group, dv), dtype=ct, device=dev)
    kpos_in = torch.arange(block, device=dev)
    for d in range(nb):
        qs, ks, vs = qb[:, d:], kb[:, :nb - d], vb[:, :nb - d]
        s = torch.einsum("bnqhgd,bnkhd->bnqhgk", qs, ks) * scale
        # every band respects kv_len (the padded tail); the diagonal band
        # is causal within its block
        kpos = (torch.arange(nb - d, device=dev) * block)[
            None, :, None, None, None, None] + kpos_in
        valid = kpos < kv_len
        if d == 0:
            valid = valid & (kpos_in[None, None, None, None, None, :]
                             <= kpos_in[None, None, :, None, None, None])
        s = torch.where(valid, s, _NEG)
        m_old = m[:, d:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        l_new = l[:, d:] * alpha + p.sum(-1)
        acc_new = acc[:, d:] * alpha[..., None] + torch.einsum(
            "bnqhgk,bnkhd->bnqhgd", upcast(p.to(vs.dtype)), upcast(vs))
        m = torch.cat([m[:, :d], m_new], dim=1)
        l = torch.cat([l[:, :d], l_new], dim=1)
        acc = torch.cat([acc[:, :d], acc_new], dim=1)

    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sp, hq, dv)[:, :sq].to(q.dtype)


def _positions(cache_len: int, batch: int, seq: int, device) -> Tensor:
    base = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + cache_len
    return base.expand(batch, seq)


def _apply_pos(q: Tensor, k: Tensor, cfg: ModelConfig, positions: Tensor,
               positions3: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    if cfg.pos_emb == "rope":
        q = rope_apply(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope_apply(k, positions, cfg.rope_theta, cfg.rope_fraction)
    elif cfg.pos_emb == "mrope":
        p3 = positions3 if positions3 is not None else \
            positions[None].expand((3,) + tuple(positions.shape))
        q = mrope_apply(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = mrope_apply(k, p3, cfg.rope_theta, cfg.mrope_sections)
    return q, k


# ---------------------------------------------------------------------------
# GQA / MQA attention
# ---------------------------------------------------------------------------

def gqa_forward(params: nn.ParameterDict, x: Tensor, cfg: ModelConfig, *,
                causal: bool = True, cache: Optional[dict] = None,
                positions3: Optional[Tensor] = None,
                impl: str = "chunked", use_kernel: Optional[bool] = None
                ) -> Tuple[Tensor, Optional[dict]]:
    """x (B, S, d) -> (out (B, S, d), cache').  With a cache, the step's k
    and v go into its rows [len, len + s) in place.  ``positions3``
    (3, B, S): M-RoPE's ids for these tokens (M-RoPE configs only)."""
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)

    cache_len = cache["len"] if cache is not None else 0
    pos = _positions(cache_len, b, s, x.device)
    q, k = _apply_pos(q, k, cfg, pos, positions3)

    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        if cache_len + s > kc.shape[1]:
            raise ValueError(f"KV cache overflow: {cache_len} cached + {s} "
                             f"new rows > s_max {kc.shape[1]}")
        kc[:, cache_len:cache_len + s] = k
        vc[:, cache_len:cache_len + s] = v
        new_cache = {"k": kc, "v": vc, "len": cache_len + s}
        out = _sdpa(q, kc, vc, causal=causal, kv_len=cache_len + s,
                    q_offset=cache_len, scale=hd ** -0.5, impl=impl,
                    use_kernel=use_kernel)
    else:
        new_cache = None
        out = _sdpa(q, k, v, causal=causal, kv_len=s, q_offset=0,
                    scale=hd ** -0.5, impl=impl, use_kernel=use_kernel)
    return out.reshape(b, s, h * hd) @ params["wo"], new_cache


# ---------------------------------------------------------------------------
# DeepSeek MLA
# ---------------------------------------------------------------------------

def mla_forward(params: MLA, x: Tensor, cfg: ModelConfig, *,
                causal: bool = True, cache: Optional[dict] = None,
                impl: str = "chunked", use_kernel: Optional[bool] = None
                ) -> Tuple[Tensor, Optional[dict]]:
    """x (B, S, d) -> (out (B, S, d), cache').  The step's normed latent
    ``ckv`` and its rotated shared key ``krope`` go into the latent cache's
    rows [len, len + s) in place; the valid prefix is expanded per head by
    ``wkv_b`` and attended by `_sdpa`'s plain math with Dv != D.
    ``use_kernel`` is taken for the mixers' common signature and unused:
    MLA never runs the kernel."""
    del use_kernel
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    ql = norm(x @ params["wq_a"], params["q_norm"], "rmsnorm", cfg.norm_eps)
    q = (ql @ params["wq_b"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    kv_a = x @ params["wkv_a"]
    ckv_new = norm(kv_a[..., :m.kv_lora_rank], params["kv_norm"], "rmsnorm",
                   cfg.norm_eps)
    krope_new = kv_a[..., m.kv_lora_rank:]                # (B,S,dr) shared

    cache_len = cache["len"] if cache is not None else 0
    pos = _positions(cache_len, b, s, x.device)
    q_rope = rope_apply(q_rope, pos, cfg.rope_theta)
    krope_new = rope_apply(krope_new[:, :, None, :], pos,
                           cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        ckv_c, krope_c = cache["ckv"], cache["krope"]
        if cache_len + s > ckv_c.shape[1]:
            raise ValueError(f"latent cache overflow: {cache_len} cached + "
                             f"{s} new rows > s_max {ckv_c.shape[1]}")
        ckv_c[:, cache_len:cache_len + s] = ckv_new
        krope_c[:, cache_len:cache_len + s] = krope_new
        new_cache = {"ckv": ckv_c, "krope": krope_c, "len": cache_len + s}
        # the rows past len + s are masked in the reference; they are left
        # out here, which saves their expansion
        ckv = ckv_c[:, :cache_len + s]
        krope = krope_c[:, :cache_len + s]
    else:
        ckv, krope = ckv_new, krope_new
        new_cache = None
    kv_len = cache_len + s

    # expand the latent kv per head (the reference's baseline)
    kv = (ckv @ params["wkv_b"]).reshape(b, kv_len, h, dn + dv)
    k_nope, vv = kv[..., :dn], kv[..., dn:]
    k_full = torch.cat([k_nope, krope[:, :, None, :].expand(
        b, kv_len, h, dr)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = _sdpa(q_full, k_full, vv, causal=causal, kv_len=kv_len,
                q_offset=cache_len, scale=(dn + dr) ** -0.5, impl=impl,
                use_kernel=False)
    return out.reshape(b, s, h * dv) @ params["wo"], new_cache


# ---------------------------------------------------------------------------
# cross attention (whisper decoder): k/v from the encoder, no causal mask
# ---------------------------------------------------------------------------

def cross_attn_init(gen: torch.Generator, cfg: ModelConfig, dtype
                    ) -> nn.ParameterDict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return nn.ParameterDict({
        "wq": nn.Parameter(dense_init(gen, d, h * hd, dtype)),
        "wk": nn.Parameter(dense_init(gen, d, h * hd, dtype)),
        "wv": nn.Parameter(dense_init(gen, d, h * hd, dtype)),
        "wo": nn.Parameter(dense_init(gen, h * hd, d, dtype))})


def cross_attn_forward(params: nn.ParameterDict, x: Tensor, enc_out: Tensor,
                       cfg: ModelConfig, impl: str = "chunked",
                       use_kernel: Optional[bool] = None) -> Tensor:
    """x (B, S, d) over the encoder's output (B, Se, d) -> (B, S, d):
    every query row sees all Se rows (``kv_len = Se``, not causal).  K and
    V are recomputed from ``enc_out`` at every call, as the reference
    does."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    se = enc_out.shape[1]
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (enc_out @ params["wk"]).reshape(b, se, h, hd)
    v = (enc_out @ params["wv"]).reshape(b, se, h, hd)
    out = _sdpa(q, k, v, causal=False, kv_len=se, q_offset=0,
                scale=hd ** -0.5, impl=impl, use_kernel=use_kernel)
    return out.reshape(b, s, h * hd) @ params["wo"]


def attn_forward(params: nn.ParameterDict, x: Tensor, cfg: ModelConfig,
                 **kw) -> Tuple[Tensor, Optional[dict]]:
    if cfg.mla is not None:
        kw.pop("positions3", None)
        return mla_forward(params, x, cfg, **kw)
    return gqa_forward(params, x, cfg, **kw)
