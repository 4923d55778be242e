"""Attention: GQA/MQA with RoPE and a KV cache.

Port of `repro.models.attention` (GQA branch).  Two compute paths for the
core attention, `_sdpa`:
  * the Hopper kernel (`kernels/flash_attention`), on CUDA tensors unless
    ``use_kernel=False``; it reads q and the caches through transposed views
    of their (B, S, H, D) layout, with the valid-prefix length and the
    causal offset as runtime arguments;
  * the reference's ``ref`` / ``chunked`` math in plain torch (full scores,
    or query blocks of `DEFAULT_Q_CHUNK`): bf16 products summed in f32, the
    softmax in f32, p rounded to the operands' dtype before p·v.

Cache contract: dict(k=(B, S_max, Hkv, Dh), v=..., len=int); a step of s
tokens writes rows [len, len + s) in place (the reference returns updated
copies) and attends to [0, len + s).  Writing past S_max raises, where the
reference's `dynamic_update_slice` would clamp the write.

MLA, M-RoPE and the block-triangular `_sdpa_tri` (reached only by the
training and dry-run paths) raise `NotImplementedError` until their slices;
cross-attention ports with the encoder-decoder slice (`LM` refuses
encoder configs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rope_apply

Tensor = torch.Tensor

DEFAULT_Q_CHUNK = 256
_NEG = -1e30


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype
              ) -> nn.ParameterDict:
    if cfg.mla is not None:
        raise NotImplementedError("MLA ports with its slice")
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
        raise NotImplementedError("MLA's latent cache ports with its slice")
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
    """q (B,Sq,H,D); k/v (B,Skv,Hkv,D); kv_len: valid kv prefix; q_offset:
    global position of q[0].  Returns (B,Sq,H,D) in q's dtype.

    use_kernel: None = the kernel on CUDA tensors, the ``ref``/``chunked``
    math on CPU ones; True = `ops.flash` (the kernel, or its plain version
    on CPU tensors); False = the ``ref``/``chunked`` math."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if impl == "tri" and causal and sq == skv:
        raise NotImplementedError("_sdpa_tri ports with the training slice")
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        out = fa_ops.flash(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, scale=scale,
                           kv_valid=kv_len, kv_offset=q_offset)
        return out.transpose(1, 2).reshape(b, sq, hq, dh)
    if q_chunk == 0:
        q_chunk = DEFAULT_Q_CHUNK
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, dh)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(skv, device=q.device)

    def block(qb: Tensor, q_pos: Tensor) -> Tensor:
        # qb (B,bq,Hkv,g,D); scores (B,Hkv,g,bq,Skv)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kf) * scale
        valid = kpos[None, :] < kv_len
        if causal:
            valid = valid & (kpos[None, :] <= (q_pos + q_offset)[:, None])
        s = torch.where(valid, s, _NEG)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd", p.to(k.dtype).float(), vf)

    pos = torch.arange(sq, device=q.device)
    if impl == "ref" or sq <= q_chunk:
        out = block(qg, pos)
    else:
        out = torch.cat([block(qg[:, lo:lo + q_chunk], pos[lo:lo + q_chunk])
                         for lo in range(0, sq, q_chunk)], dim=1)
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def _positions(cache_len: int, batch: int, seq: int, device) -> Tensor:
    base = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + cache_len
    return base.expand(batch, seq)


def _apply_pos(q: Tensor, k: Tensor, cfg: ModelConfig, positions: Tensor
               ) -> Tuple[Tensor, Tensor]:
    if cfg.pos_emb == "rope":
        q = rope_apply(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope_apply(k, positions, cfg.rope_theta, cfg.rope_fraction)
    elif cfg.pos_emb == "mrope":
        raise NotImplementedError("M-RoPE ports with the qwen2-vl slice")
    return q, k


# ---------------------------------------------------------------------------
# GQA / MQA attention
# ---------------------------------------------------------------------------

def gqa_forward(params: nn.ParameterDict, x: Tensor, cfg: ModelConfig, *,
                causal: bool = True, cache: Optional[dict] = None,
                impl: str = "chunked", use_kernel: Optional[bool] = None
                ) -> Tuple[Tensor, Optional[dict]]:
    """x (B, S, d) -> (out (B, S, d), cache').  With a cache, the step's k
    and v go into its rows [len, len + s) in place."""
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
    q, k = _apply_pos(q, k, cfg, pos)

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


def mla_forward(*args, **kw):
    raise NotImplementedError("MLA ports with its slice")


def attn_forward(params: nn.ParameterDict, x: Tensor, cfg: ModelConfig,
                 **kw) -> Tuple[Tensor, Optional[dict]]:
    if cfg.mla is not None:
        return mla_forward(params, x, cfg, **kw)
    return gqa_forward(params, x, cfg, **kw)
