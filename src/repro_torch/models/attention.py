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

A sharded serving step's cache (`make_kv_cache` with a mesh) is this
rank's block under the reference's `cache_shardings`: k and v (B / data,
S_max / n, Hkv, Dh) with ``mesh`` and ``seq``, the axes its sequence is
cut over (n ranks; none where S_max does not divide), ``len`` global.
Rank r holds rows [r S_loc, (r + 1) S_loc).  `gqa_forward` writes the
rows of its own segment; a prefill attends over the prompt's own k and v;
a decode step gathers q to every head, attends over its segment, and
combines the ranks' partials by their log-sum-exps
(`launch.mesh.combine_partials`).

MLA expands the latent cache per head as the reference's baseline does (no
absorbed matmul) and always runs `_sdpa`'s plain math, as the reference
runs MLA on its jnp math: the kernel takes Dv = D only.  A sharded serving
step's latent cache is cut by sequence too (ckv (B / data, S_max / n,
kv_lora), krope (B / data, S_max / n, dr)); `_mla_cut_cache` writes the
rank's rows, a prefill attends over the prompt's own latent on the rank's
heads, and a later step gathers q to every head, expands the rank's
segment for every head with the whole ``wkv_b`` (which the steps place
whole) and combines the ranks' partials as GQA's decode does.

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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, mrope_apply, norm,
                                       norm_init, rope_apply, upcast)
from repro_torch.sharding import hint

Tensor = torch.Tensor

DEFAULT_Q_CHUNK = 256
_NEG = -1e30
#: private test hooks that break the products on a "model" cut (the
#: controls of the tests): "krope_unsummed" (MLA's shared key without
#: its gradient's sum), "mla_own_wkv_b" (MLA's decode expanding the
#: rank's segment for its own heads only), "cross_unsummed_wo"
#: (cross-attention without its row product's sum)
_CONTROLS: frozenset = frozenset()


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
                  device="cuda", *, mesh=None, spec=()) -> dict:
    """An empty cache of ``batch`` rows of ``s_max``; with ``mesh``, this
    rank's block of it under ``spec`` (the k leaf's partition spec:
    batch, sequence, kv heads; MLA's ckv leaf's: batch, sequence), and
    the sequence's axes (module docstring)."""
    if mesh is not None:
        seq = spec[1] if len(spec) > 1 and spec[1] else ()
        seq = (seq,) if isinstance(seq, str) else tuple(seq)
        if cfg.mla is not None:
            m = cfg.mla
            out = {k: torch.zeros(mesh_lib.block_shape(
                (batch, s_max, width), spec, mesh), dtype=dtype,
                device=device) for k, width in (
                    ("ckv", m.kv_lora_rank), ("krope", m.qk_rope_head_dim))}
            return {**out, "len": 0, "mesh": mesh, "seq": seq}
        shape = mesh_lib.block_shape(
            (batch, s_max, cfg.n_kv_heads, cfg.head_dim), spec, mesh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "len": 0, "mesh": mesh, "seq": seq}
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
          use_kernel: Optional[bool] = None, return_lse: bool = False):
    """q (B,Sq,H,D); k (B,Skv,Hkv,D); v (B,Skv,Hkv,Dv); kv_len: valid kv
    prefix; q_offset: global position of q[0].  Returns (B,Sq,H,Dv) in q's
    dtype.

    use_kernel: None = the kernel on CUDA tensors, the plain math on CPU
    ones; True = `ops.flash` (the kernel, or its plain version on CPU
    tensors; Dv = D only); False = the plain math: ``impl`` "ref" (full
    scores), "chunked" (query blocks, recomputed in backward) or "tri"
    (`_sdpa_tri`, causal with Sq = Skv; otherwise the chunked math).

    ``return_lse``: a partial over a segment of a cache cut by sequence,
    (out (B,Sq,H,D) in f32, each row's log-sum-exp (B,Sq,H) in f32); the
    kernel's decode body on the card, the full-score math without it; a
    row with no valid key (``kv_len`` may be 0) gets out = 0, lse =
    -inf."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        out = fa_ops.flash(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, scale=scale,
                           kv_valid=kv_len, kv_offset=q_offset,
                           return_lse=return_lse)
        if return_lse:
            out, lse = out
            return (out.transpose(1, 2).reshape(b, sq, hq, dh),
                    lse.transpose(1, 2))
        return out.transpose(1, 2).reshape(b, sq, hq, dh)
    if return_lse:
        return _sdpa_lse(q, k, v, causal=causal, kv_len=kv_len,
                         q_offset=q_offset, scale=scale)
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


def _sdpa_lse(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, kv_len: int,
              q_offset: int, scale: float) -> Tuple[Tensor, Tensor]:
    """`_sdpa`'s full-score math as a partial: (out (B,Sq,H,Dv) f32, lse
    (B,Sq,H) f32), p rounded to v's dtype before p·v as there; a row with
    no valid key gets out = 0 and lse = -inf."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", upcast(qg), upcast(k)) * scale
    kpos = torch.arange(skv, device=q.device)
    valid = (kpos < kv_len)[None, :]
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        valid = valid & (kpos[None, :] <= qpos[:, None])
    s = torch.where(valid, s, _NEG)
    seen = valid.any(dim=-1)                           # (Sq,)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", upcast(p.to(v.dtype)), upcast(v))
    out = torch.where(seen[None, :, None, None, None], out, 0.0)
    lse = torch.where(seen, torch.logsumexp(s, -1),
                      float("-inf"))                   # (B,Hkv,g,Sq)
    return (out.reshape(b, sq, hq, v.shape[-1]).float(),
            lse.permute(0, 3, 1, 2).reshape(b, sq, hq).float())


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
    (3, B, S): M-RoPE's ids for these tokens (M-RoPE configs only).

    Where the sharded train step cut the layer over ``"model"``
    (`tensor_parallel.cuts`), ``wq`` / ``bq`` are the rank's query heads'
    columns and ``wo`` their rows, its output summed over ``"model"``;
    ``wk`` / ``wv`` / ``bk`` / ``bv`` are its kv heads' columns, or whole,
    and then the rank attends with the kv heads its query heads use
    (`_own_kv`).  The head counts are the leaves' widths.

    A sharded serving step's cache block (`make_kv_cache` with a mesh)
    goes through `_attend_cut_cache`."""
    b, s, d = x.shape
    hd = cfg.head_dim
    mesh = tp.mesh_of(params["wq"])
    p = {k: tp.block(w) for k, w in params.items()}
    if mesh is not None:
        x = mesh_lib.sum_grad(x, mesh, "model")      # column products' input
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    h, hkv = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)

    cache_len = cache["len"] if cache is not None else 0
    pos = _positions(cache_len, b, s, x.device)
    q, k = _apply_pos(q, k, cfg, pos, positions3)
    if cache is not None and cache.get("mesh") is not None:
        out, new_cache = _attend_cut_cache(q, k, v, cache, cfg, mesh,
                                           causal=causal, impl=impl,
                                           use_kernel=use_kernel)
        out = out.reshape(b, s, h * hd) @ p["wo"]
        if mesh is not None:                         # the row product's sum
            out = mesh_lib.all_reduce_grad(out, mesh, "model", ())
        return out, new_cache
    if h < cfg.n_heads and hkv == cfg.n_kv_heads:
        k, v = _own_kv(k, v, cfg, h * mesh.index("model"), h)

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
    out = out.reshape(b, s, h * hd) @ p["wo"]
    if mesh is not None:                             # the row product's sum
        out = mesh_lib.all_reduce_grad(out, mesh, "model", ())
    return out, new_cache


def _heads_over_model(t: Tensor, mesh) -> Tensor:
    """(B, S, H_loc, D) cut over ``"model"`` by heads -> every head."""
    whole = mesh.all_gather(t.permute(2, 0, 1, 3).contiguous(), "model")
    return whole.permute(1, 2, 0, 3)


def _attend_cut_cache(q: Tensor, k: Tensor, v: Tensor, cache: dict,
                      cfg: ModelConfig, mesh, *, causal: bool, impl: str,
                      use_kernel: Optional[bool]) -> Tuple[Tensor, dict]:
    """Attention of a sharded serving step on this rank's cache block
    (module docstring): q (B, s, h, D) the rank's query heads, k / v the
    heads it computed (its cut over ``"model"``, or every kv head), all
    rotated at their global positions.  Returns (out (B, s, h, D) for the
    rank's query heads, the cache with ``len`` advanced).

    The block holds every kv head or the rank's cut of them (the heads
    ``cache_shardings`` leaves when the sequence claims ``"model"``); the
    rank gathers its computed heads over ``"model"`` where the block holds
    more, and writes the rows of [len, len + s) that fall in its segment.
    A cache whole along the sequence attends as the local path.  Else a
    prefill (``len`` 0) attends over the prompt's own k and v on the
    rank's heads, and a later step gathers q to every head, attends over
    the rank's segment (``kv_len`` its valid rows, clamped to [0, S_loc])
    for a partial with its log-sum-exp, and combines the segments' in
    segment order (`launch.mesh.combine_partials`), of which the rank
    keeps its query heads."""
    b, s, h, hd = q.shape
    kc, vc, length = cache["k"], cache["v"], cache["len"]
    first = h * mesh.index("model") if h < cfg.n_heads else 0
    kw, vw = k, v
    if kc.shape[2] != k.shape[2]:
        if mesh is None or kc.shape[2] != k.shape[2] * mesh.size("model"):
            raise NotImplementedError(
                f"a cache block of {kc.shape[2]} kv heads beside "
                f"{k.shape[2]} computed")
        kw, vw = (_heads_over_model(t, mesh) for t in (k, v))
    cmesh, seq, n, r, s_loc, new_cache = _write_segment(
        cache, {"k": kw, "v": vw})

    def own(kk, vv):
        if h < cfg.n_heads and kk.shape[2] == cfg.n_kv_heads:
            return _own_kv(kk, vv, cfg, first, h)
        return kk, vv

    kw_ = dict(causal=causal, scale=hd ** -0.5, impl=impl,
               use_kernel=use_kernel)
    if n == 1:
        kk, vv = own(kc, vc)
        return _sdpa(q, kk, vv, kv_len=length + s, q_offset=length,
                     **kw_), new_cache
    if length == 0:
        kk, vv = own(k, v)
        return _sdpa(q, kk, vv, kv_len=s, q_offset=0, **kw_), new_cache
    qa = _heads_over_model(q, mesh) if h < cfg.n_heads else q
    part, lse = _sdpa(qa, kc, vc, kv_len=min(max(length + s - r * s_loc, 0),
                                             s_loc),
                      q_offset=length - r * s_loc, return_lse=True, **kw_)
    out = mesh_lib.combine_partials(part, lse, cmesh, seq).to(q.dtype)
    return out[:, :, first:first + h], new_cache


def _write_segment(cache: dict, rows: dict):
    """Write a step's ``rows`` ({cache key: (B, s, ...)}, the step's rows
    [len, len + s)) that fall in this rank's segment of a cache cut by
    sequence: (the cache's mesh, its sequence's axes, their size n, the
    rank's index r along them, the segment's rows S_loc, the cache with
    ``len`` advanced).  Rank r holds rows [r S_loc, (r + 1) S_loc); a
    cache without a mesh is one segment (n 1, r 0)."""
    cmesh, seq, length = cache.get("mesh"), cache.get("seq", ()), \
        cache["len"]
    n = cmesh.size(seq) if cmesh is not None else 1
    r = cmesh.index(seq) if seq else 0
    s = next(iter(rows.values())).shape[1]
    s_loc = cache[next(iter(rows))].shape[1]
    if length + s > n * s_loc:
        raise ValueError(f"cache overflow: {length} cached + {s} new rows "
                         f"> s_max {n * s_loc}")
    lo, hi = max(length, r * s_loc), min(length + s, (r + 1) * s_loc)
    if lo < hi:
        for key, new in rows.items():
            cache[key][:, lo - r * s_loc:hi - r * s_loc] = \
                new[:, lo - length:hi - length]
    return cmesh, seq, n, r, s_loc, {**cache, "len": length + s}


def _own_kv(k: Tensor, v: Tensor, cfg: ModelConfig, first: int, count: int
            ) -> Tuple[Tensor, Tensor]:
    """The whole kv heads (B, S, Hkv, D) cut to those query heads
    ``[first, first + count)`` use, laid out for `_sdpa`'s grouping:
    global query head ``j`` uses kv head ``j // (H / Hkv)``.  Where the
    rank's query heads fill whole groups, or lie in one group, that is a
    slice of the kv heads; otherwise one kv head a query head."""
    group = cfg.n_heads // cfg.n_kv_heads
    lo, hi = first // group, (first + count - 1) // group + 1
    if count % group == 0 or hi - lo == 1:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    ids = torch.arange(first, first + count, device=k.device) // group
    return k.index_select(2, ids), v.index_select(2, ids)


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
    ``wkv_b`` and attended by `_sdpa`'s plain math with Dv != D
    (`_mla_cut_cache`, with or without a mesh).
    ``use_kernel`` is taken for the mixers' common signature and unused:
    MLA never runs the kernel.

    Where the sharded steps cut the layer over ``"model"``
    (`tensor_parallel.cuts`), ``wq_b`` and ``wkv_b`` are the rank's heads'
    columns (or ``wkv_b`` whole, as the serving steps place it: the rank
    takes its heads' columns) and ``wo`` their rows, its output summed
    over ``"model"``; the normed latents ``ql`` and ``ckv`` (the column
    products' inputs) and ``krope`` (read by every head) go through
    `launch.mesh.sum_grad`."""
    del use_kernel
    m = cfg.mla
    b, s, _ = x.shape
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    mesh = tp.mesh_of(params["wq_b"])
    wq_b, wkv_b, wo = (tp.block(params[k]) for k in ("wq_b", "wkv_b", "wo"))

    ql = norm(x @ params["wq_a"], params["q_norm"], "rmsnorm", cfg.norm_eps)
    kv_a = x @ params["wkv_a"]
    ckv_new = norm(kv_a[..., :m.kv_lora_rank], params["kv_norm"], "rmsnorm",
                   cfg.norm_eps)
    krope_new = kv_a[..., m.kv_lora_rank:]                # (B,S,dr) shared
    if mesh is not None:             # the rank reads them for its heads
        ql = mesh_lib.sum_grad(ql, mesh, "model")
        ckv_new = mesh_lib.sum_grad(ckv_new, mesh, "model")
        if "krope_unsummed" not in _CONTROLS:
            krope_new = mesh_lib.sum_grad(krope_new, mesh, "model")
    q = ql @ wq_b
    h = q.shape[-1] // (dn + dr)
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    own_kv_b = wkv_b
    if wkv_b.shape[1] > h * (dn + dv):  # placed whole: the rank's columns
        first = h * (dn + dv) * mesh.index("model")
        own_kv_b = wkv_b[:, first:first + h * (dn + dv)]

    pos = _positions(cache["len"] if cache is not None else 0, b, s,
                     x.device)
    q_rope = rope_apply(q_rope, pos, cfg.rope_theta)
    krope_new = rope_apply(krope_new[:, :, None, :], pos,
                           cfg.rope_theta)[:, :, 0, :]
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    if cache is not None:
        out, new_cache = _mla_cut_cache(q_full, ckv_new, krope_new, cache,
                                        cfg, mesh, own_kv_b, wkv_b,
                                        causal=causal, impl=impl)
    else:
        k_full, vv = _mla_expand(ckv_new, krope_new, own_kv_b, m)
        out = _sdpa(q_full, k_full, vv, causal=causal, kv_len=s, q_offset=0,
                    scale=(dn + dr) ** -0.5, impl=impl, use_kernel=False)
        new_cache = None
    out = out.reshape(b, s, h * dv) @ wo
    if mesh is not None:                             # the row product's sum
        out = mesh_lib.all_reduce_grad(out, mesh, "model", ())
    return out, new_cache


def _mla_expand(ckv: Tensor, krope: Tensor, wkv_b: Tensor, m
                ) -> Tuple[Tensor, Tensor]:
    """The latent (B, T, kv_lora) and shared key (B, T, dr) expanded per
    head of ``wkv_b``'s columns (the reference's baseline): (k (B, T, h,
    dn + dr), v (B, T, h, dv))."""
    b, t, _ = ckv.shape
    dn, dv = m.qk_nope_head_dim, m.v_head_dim
    h = wkv_b.shape[1] // (dn + dv)
    kv = (ckv @ wkv_b).reshape(b, t, h, dn + dv)
    k_nope, vv = kv[..., :dn], kv[..., dn:]
    return torch.cat([k_nope, krope[:, :, None, :].expand(
        b, t, h, m.qk_rope_head_dim)], dim=-1), vv


def _mla_cut_cache(q: Tensor, ckv: Tensor, krope: Tensor, cache: dict,
                   cfg: ModelConfig, mesh, own_kv_b: Tensor, wkv_b: Tensor,
                   *, causal: bool, impl: str) -> Tuple[Tensor, dict]:
    """MLA's `_attend_cut_cache`: q (B, s, h, dn + dr) the rank's query
    heads, ckv (B, s, kv_lora) and krope (B, s, dr) the step's latent
    rows (whole along ``"model"``), rotated at their global positions;
    ``own_kv_b`` the rank's heads' columns of ``wkv_b``, ``wkv_b`` as
    placed (whole in serving).  Returns (out (B, s, h, dv), the cache with
    ``len`` advanced).  The local cache (no mesh) is one whole segment.

    The rank writes the rows of [len, len + s) that fall in its segment.
    A cache whole along the sequence attends over its valid rows (the
    reference masks the rows past len + s; leaving them out saves their
    expansion), on the rank's heads; a prefill (``len`` 0) attends over
    the prompt's own latent on them.  A later step gathers q to every
    head, expands the rank's valid rows for every head, takes the partial
    and its log-sum-exp (`_sdpa_lse`), combines the segments'
    (`launch.mesh.combine_partials`) and keeps the rank's heads."""
    m = cfg.mla
    b, s, h, _ = q.shape
    ckv_c, krope_c, length = cache["ckv"], cache["krope"], cache["len"]
    cmesh, seq, n, r, s_loc, new_cache = _write_segment(
        cache, {"ckv": ckv, "krope": krope})
    kw = dict(causal=causal, scale=(m.qk_nope_head_dim
                                    + m.qk_rope_head_dim) ** -0.5)
    if n == 1 or length == 0:
        if n == 1:
            ckv, krope = ckv_c[:, :length + s], krope_c[:, :length + s]
        k, v = _mla_expand(ckv, krope, own_kv_b, m)
        return _sdpa(q, k, v, kv_len=k.shape[1], q_offset=k.shape[1] - s,
                     impl=impl, use_kernel=False, **kw), new_cache
    own = "mla_own_wkv_b" in _CONTROLS
    qa = q if own or h == cfg.n_heads else _heads_over_model(q, mesh)
    valid = min(max(length + s - r * s_loc, 0), s_loc)
    if valid == 0:                   # an empty segment weighs nothing
        part = q.new_zeros((b, s, qa.shape[2], m.v_head_dim),
                           dtype=torch.float32)
        lse = torch.full((b, s, qa.shape[2]), float("-inf"),
                         device=q.device)
    else:
        k, v = _mla_expand(ckv_c[:, :valid], krope_c[:, :valid],
                           own_kv_b if own else wkv_b, m)
        part, lse = _sdpa_lse(qa, k, v, kv_len=valid,
                              q_offset=length - r * s_loc, **kw)
    out = mesh_lib.combine_partials(part, lse, cmesh, seq).to(q.dtype)
    if own or h == cfg.n_heads:
        return out, new_cache
    first = h * mesh.index("model")
    return out[:, :, first:first + h], new_cache


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
    does.

    Where the sharded steps cut the layer over ``"model"``
    (`tensor_parallel.cuts`), ``wq`` is the rank's heads' columns and
    ``wo`` their rows, its output summed over ``"model"``; ``wk`` / ``wv``
    are the rank's heads' columns, or whole, and then the rank takes its
    heads' columns of them.  ``x`` and ``enc_out`` (the column products'
    inputs, ``enc_out`` once for both of its) go through
    `launch.mesh.sum_grad`."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    se = enc_out.shape[1]
    mesh = tp.mesh_of(params["wq"])
    p = {k: tp.block(w) for k, w in params.items()}
    if mesh is not None:
        x = mesh_lib.sum_grad(x, mesh, "model")
        enc_out = mesh_lib.sum_grad(enc_out, mesh, "model")
    q = x @ p["wq"]
    h = q.shape[-1] // hd
    wk, wv = p["wk"], p["wv"]
    if wk.shape[1] > h * hd:         # kv leaves whole beside cut q heads
        first = h * hd * mesh.index("model")
        wk, wv = (w[:, first:first + h * hd] for w in (wk, wv))
    q = q.reshape(b, s, h, hd)
    k = (enc_out @ wk).reshape(b, se, h, hd)
    v = (enc_out @ wv).reshape(b, se, h, hd)
    out = _sdpa(q, k, v, causal=False, kv_len=se, q_offset=0,
                scale=hd ** -0.5, impl=impl, use_kernel=use_kernel)
    out = out.reshape(b, s, h * hd) @ p["wo"]
    if mesh is not None and "cross_unsummed_wo" not in _CONTROLS:
        out = mesh_lib.all_reduce_grad(out, mesh, "model", ())
    return out


def attn_forward(params: nn.ParameterDict, x: Tensor, cfg: ModelConfig,
                 **kw) -> Tuple[Tensor, Optional[dict]]:
    if cfg.mla is not None:
        kw.pop("positions3", None)
        return mla_forward(params, x, cfg, **kw)
    return gqa_forward(params, x, cfg, **kw)
