"""Wrapper of the Hopper flash-attention kernel (`csrc/flash_attention.cu`)
and its plain version.

Port of `repro.kernels.flash_attention.kernel`.  Streaming-softmax attention
with GQA: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); query head h reads KV head
h // (Hq // Hkv).  Key j is valid for query row i when ``j < kv_valid`` and,
if causal, ``j <= i + kv_offset`` (``kv_offset`` is the causal diagonal
shift, ``Skv - Sq`` by default).  Scores, softmax statistics and the
accumulator are f32; the output has q's dtype.

`flash_attention` on a CUDA tensor launches the kernel (building the library
at first use) or raises; on a CPU tensor it runs `flash_attention_plain`.
There is no fallback from the kernel to the plain version.  The kernel reads
its operands through their strides, so the model hands it transposed views
of its (B, S, H, D) tensors and KV caches without a copy.  `LAUNCHES` counts
kernel launches, one per call that launched.

A call with at most 16 rows per (batch, KV head), Sq * Hq / Hkv <= 16 (a
decode step; the library reports the limit), splits its KV walk across
`decode_splits` CTAs and combines their partials in split order inside the
same launch; `flash_attention_split_plain` is that algorithm in plain
torch.  Such a call can also return a rank's partial over its segment of a
KV cache cut by sequence (``return_lse``): its output in f32 and each
row's log-sum-exp, which `launch.mesh.combine_partials` combines across
ranks.  A segment may then hold no valid key yet (``kv_valid=0``): the
kernel still launches and gives out = 0, lse = -inf.  `LSE_LAUNCHES`
counts the launches that wrote it.  Longer calls in bf16 run both
products on tensor cores, p·v as the three bf16 parts of the f32 p that
`bf16_parts` computes (`kernel_bf16_parts` runs the kernel's own split,
for the checks).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import NvccLibrary, is_fake

Tensor = torch.Tensor

#: what `csrc/flash_attention.cu` takes: D % 32 == 0 and D <= 256
KERNEL_D_MULTIPLE, KERNEL_D_MAX = 32, 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30
#: keys per KV tile
BN = 64

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"flash_attention": 0}
#: of those, the launches that wrote each row's log-sum-exp
LSE_LAUNCHES = {"flash_attention": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: `csrc/flash_attention.cu`, built by nvcc at first launch
LIBRARY = NvccLibrary("flash_attention", Path(__file__).resolve().parent
                      / "csrc" / "flash_attention.cu", {
    # q, k, v, out, dtype, b, hq, hkv, sq, d, kv_valid, kv_offset, causal,
    # scale, (batch, head, seq) strides of q, k, v, out, decode splits,
    # decode scratch, decode tickets, lse (then out in f32), stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, ctypes.c_float) + (_LL,) * 12
                              + (_I, _P, _P, _P, _P),
    # rows, max_splits: the decode body's limits
    "flash_attention_decode_limits": (ctypes.POINTER(_I),) * 2,
    # p, hi, mid, lo, n, stream
    "flash_split3_launch": (_P, _P, _P, _P, _LL, _P),
})
#: per device, the decode calls' ticket counters: zero between calls (the
#: combining CTA of each row group resets its own), so calls on one stream
#: share them
_TICKETS: Dict[torch.device, Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LSE_LAUNCHES[k] = 0


def _resolve(q: Tensor, k: Tensor, v: Tensor, scale: Optional[float],
             kv_valid: Optional[int], kv_offset: Optional[int],
             empty_ok: bool = False) -> Tuple[float, int, int]:
    """Check the shapes (any device) and fill the defaults; ``empty_ok``
    lets ``kv_valid`` be 0 (a partial over a segment with no valid key)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes q (B, Hq, Sq, D) and k/v "
                         "(B, Hkv, Skv, D)")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         f"(Dv != D waits for MLA)")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    kv_valid = skv if kv_valid is None else int(kv_valid)
    kv_offset = skv - sq if kv_offset is None else int(kv_offset)
    if not (0 if empty_ok else 1) <= kv_valid <= skv:
        raise ValueError(f"kv_valid={kv_valid} outside "
                         f"[{0 if empty_ok else 1}, Skv={skv}]")
    return (d ** -0.5 if scale is None else float(scale)), kv_valid, kv_offset


def _kv_end(sq: int, kv_valid: int, kv_offset: int, causal: bool) -> int:
    """One past the last key any row may see: the kernel walks [0, kv_end)."""
    return min(kv_valid, sq + kv_offset) if causal else kv_valid


def decode_splits(kv_end: int, groups: int, sms: int,
                  max_splits: int) -> int:
    """CTAs per row group of a decode call: one per 64-key tile, as long as
    all ``groups`` (B * Hkv) row groups together take no more CTAs than
    there are SMs, and at most ``max_splits`` (the decode body's limit);
    then as few as leave no split empty.  A CTA's walk is latency-bound, so
    the call takes about one tile's time plus the combine."""
    tiles = max(-(-kv_end // BN), 1)
    splits = min(tiles, max(sms // groups, 1), max_splits)
    per = -(-tiles // splits)
    return -(-tiles // per)


def bf16_parts(p: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """f32 p as three bf16 tensors hi, mid, lo with hi + mid + lo == p: each
    subtraction is exact in f32, and the three 8-bit significands cover p's
    24 bits.  Each part times a bf16 value is exact in f32, so the kernel's
    p·v on bf16 tensor cores is hi·v + mid·v + lo·v with p kept in f32."""
    hi = p.to(torch.bfloat16)
    r = p - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _partial(out: Tensor, lse: Optional[Tensor], q: Tensor):
    """From f32 ``out`` and ``lse`` (B, Hkv, group, Sq, ...): the partial
    (out (B, Hq, Sq, D), lse (B, Hq, Sq)) in f32, or without ``lse`` the
    output alone in q's dtype."""
    b, hq, sq, d = q.shape
    if lse is None:
        return out.reshape(b, hq, sq, d).to(q.dtype)
    return out.reshape(b, hq, sq, d), lse.reshape(b, hq, sq)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          kv_valid: Optional[int] = None,
                          kv_offset: Optional[int] = None,
                          p_to_bf16: bool = False, return_lse: bool = False):
    """The kernel's function in plain torch: q, k and v upcast to f32, q
    scaled, the mask selected to -1e30, an f32 softmax, the output in q's
    dtype.  Keys at or past ``kv_valid`` are left out, as the kernel never
    loads them.  ``p_to_bf16`` rounds p to bf16 before p·v (the normalizer
    stays f32): SDPA's function, not the kernel's, the control that shows a
    check can tell a kernel that keeps p in f32 from one that does not.
    ``return_lse``: the partial, (out in f32, each row's log-sum-exp (B,
    Hq, Sq) in f32, m + log l); a row that sees no key then gets out = 0
    and lse = -inf, as the decode body gives them."""
    scale, kv_valid, kv_offset = _resolve(q, k, v, scale, kv_valid,
                                          kv_offset, empty_ok=return_lse)
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d) * scale
    kf = k[:, :, :kv_valid].float()
    vf = v[:, :, :kv_valid].float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    ok = None
    if causal:
        qpos = torch.arange(sq, device=q.device) + kv_offset
        kpos = torch.arange(kv_valid, device=q.device)
        ok = kpos[None, :] <= qpos[:, None]
        s = torch.where(ok, s, _NEG)
    m = s.amax(dim=-1, keepdim=True) if kv_valid else \
        s.new_full(s.shape[:-1] + (1,), _NEG)
    p = torch.exp(s - m)
    if return_lse and ok is not None:  # a row with no valid key weighs 0
        p = torch.where(ok, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if p_to_bf16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))[..., 0] \
        if return_lse else None
    return _partial(out, lse, q)


def flash_attention_split_plain(q: Tensor, k: Tensor, v: Tensor, *,
                                splits: int, causal: bool = True,
                                scale: Optional[float] = None,
                                kv_valid: Optional[int] = None,
                                kv_offset: Optional[int] = None,
                                return_lse: bool = False):
    """The decode kernel's algorithm in plain torch: the walk [0, kv_end) cut
    into ``splits`` ranges of whole 64-key tiles, each giving an f32 partial
    (m, l, acc) in which masked keys weigh 0 (a range that a row cannot see
    leaves m = -1e30, l = 0), then combined in split order:
    out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30), in
    q's dtype.  ``return_lse``: the partial, (out in f32, each row's
    log-sum-exp M + log l, -inf where l = 0); ``kv_valid`` may be 0."""
    scale, kv_valid, kv_offset = _resolve(q, k, v, scale, kv_valid,
                                          kv_offset, empty_ok=return_lse)
    if splits < 1:
        raise ValueError(f"splits={splits} < 1")
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d) * scale
    kv_end = max(_kv_end(sq, kv_valid, kv_offset, causal), 0)
    tiles = -(-kv_end // BN)
    per = -(-tiles // splits) * BN                  # keys per split
    qpos = torch.arange(sq, device=q.device) + kv_offset
    m_all, l_all, acc_all = [], [], []
    for s in range(splits):
        lo, hi = min(s * per, kv_end), min((s + 1) * per, kv_end)
        kpos = torch.arange(lo, hi, device=q.device)
        ok = (kpos[None, :] <= qpos[:, None]) if causal else \
            torch.ones((sq, hi - lo), dtype=torch.bool, device=q.device)
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, lo:hi].float())
        sc = torch.where(ok, sc, _NEG)
        m = torch.cat([sc, sc.new_full(sc.shape[:-1] + (1,), _NEG)],
                      dim=-1).amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(sc - m), 0.0)
        m_all.append(m)
        l_all.append(p.sum(dim=-1, keepdim=True))
        acc_all.append(torch.einsum("bhgqk,bhkd->bhgqd", p,
                                    v[:, :, lo:hi].float()))
    mx = torch.stack(m_all).amax(dim=0)
    den = torch.zeros_like(mx)
    out = torch.zeros_like(qf)
    for m, l, acc in zip(m_all, l_all, acc_all):
        w = torch.exp(m - mx)
        den = den + w * l
        out = out + w * acc
    out = out / torch.clamp(den, min=1e-30)
    lse = torch.where(den > 0, mx + torch.log(den), float("-inf"))[..., 0] \
        if return_lse else None
    return _partial(out, lse, q)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def decode_limits() -> Tuple[int, int]:
    """The decode body's limits, as the library reports them: the most rows
    per (batch, KV head) of a decode call, and the most CTAs per row
    group.  Builds the library."""
    rows, max_splits = ctypes.c_int(), ctypes.c_int()
    LIBRARY.launch("flash_attention_decode_limits", ctypes.byref(rows),
                   ctypes.byref(max_splits))
    return rows.value, max_splits.value


def kernel_bf16_parts(p: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """`bf16_parts` as the tensor-core prefill computes it: on a CUDA f32
    tensor, the kernel's own split (``split3``), launched alone so checks
    can hold it against `bf16_parts` bit for bit; on a CPU tensor,
    `bf16_parts`.  No path of the model calls it, and `LAUNCHES` does not
    count it."""
    if p.device.type == "cpu":
        return bf16_parts(p)
    if is_fake(p):
        return tuple(torch.empty(p.shape, dtype=torch.bfloat16,
                                 device=p.device) for _ in range(3))
    if p.dtype != torch.float32:
        raise TypeError(f"kernel_bf16_parts takes float32, got {p.dtype}")
    flat = p.contiguous().reshape(-1)
    n = flat.numel()
    parts = torch.empty((3, n + n % 2), dtype=torch.bfloat16, device=p.device)
    if n:
        with torch.cuda.device(p.device):
            LIBRARY.launch("flash_split3_launch", flat.data_ptr(),
                           parts[0].data_ptr(), parts[1].data_ptr(),
                           parts[2].data_ptr(), n,
                           torch.cuda.current_stream(p.device).cuda_stream)
    return tuple(t[:n].reshape(p.shape) for t in parts)


def _tickets(device: torch.device, n: int) -> Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return t


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    """Validate what the kernel takes; raise on anything else."""
    d = q.shape[-1]
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q is {q.dtype}, k/v {t.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if d % KERNEL_D_MULTIPLE or d > KERNEL_D_MAX:
        raise ValueError(f"flash_attention kernel takes D % "
                         f"{KERNEL_D_MULTIPLE} == 0 and D <= {KERNEL_D_MAX}, "
                         f"got D={d}")
    if q.shape[0] > 65535 or k.shape[1] > 65535:
        raise ValueError("flash_attention kernel takes B, Hkv <= 65535")
    for t in (q, k, v):
        e = 16 // t.element_size()          # elements in 16 bytes
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(s % e for s, n in zip(t.stride()[:3], t.shape[:3])
                       if n > 1):
            raise ValueError("flash_attention kernel takes tensors with a "
                             "contiguous D axis, strides that are multiples "
                             "of 16 bytes, and 16-byte-aligned data")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    scale: Optional[float] = None,
                    kv_valid: Optional[int] = None,
                    kv_offset: Optional[int] = None,
                    return_lse: bool = False):
    """Attention of q (B, Hq, Sq, D) over k/v (B, Hkv, Skv, D); returns
    (B, Hq, Sq, D) in q's dtype, laid out in memory as q is.
    ``return_lse``: a rank's partial, (out in f32, lse (B, Hq, Sq) f32
    each row's log-sum-exp); ``kv_valid`` may then be 0.  On the card it
    is the decode body's (at most `decode_limits` rows per (batch, KV
    head)): a longer call that asks for it raises."""
    scale, kv_valid, kv_offset = _resolve(q, k, v, scale, kv_valid,
                                          kv_offset, empty_ok=return_lse)
    out_dtype = torch.float32 if return_lse else q.dtype
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_valid=kv_valid, kv_offset=kv_offset,
                                     return_lse=return_lse)
    b, hq, sq, d = q.shape
    if is_fake(q):
        out = torch.empty_like(q, dtype=out_dtype)
        return (out, torch.empty((b, hq, sq), dtype=torch.float32,
                                 device=q.device)) if return_lse else out
    _check(q, k, v)
    out = torch.empty_like(q, dtype=out_dtype)   # q's strides
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    hkv = k.shape[1]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    splits, scratch, tickets = 0, None, None
    rows, max_splits = decode_limits()
    if return_lse and sq * (hq // hkv) > rows:
        raise ValueError(f"flash_attention: a partial (the log-sum-exp) is "
                         f"the decode body's, at most {rows} rows per "
                         f"(batch, KV head); this call has "
                         f"{sq * (hq // hkv)}")
    if sq * (hq // hkv) <= rows:
        splits = decode_splits(_kv_end(sq, kv_valid, kv_offset, causal),
                               b * hkv, _sm_count(q.device), max_splits)
        scratch = torch.empty(b * hkv * splits * rows * (d + 2),
                              dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, b * hkv)
    with torch.cuda.device(q.device):
        LIBRARY.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], b,
                       hq, hkv, sq, d, kv_valid, kv_offset, int(causal),
                       scale, *strides, splits,
                       None if scratch is None else scratch.data_ptr(),
                       None if tickets is None else tickets.data_ptr(),
                       None if lse is None else lse.data_ptr(),
                       torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention"] += 1
    if return_lse:
        LSE_LAUNCHES["flash_attention"] += 1
        return out, lse
    return out
