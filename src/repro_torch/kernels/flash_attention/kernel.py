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
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import NvccLibrary

Tensor = torch.Tensor

#: what `csrc/flash_attention.cu` takes: D % 32 == 0 and D <= 256
KERNEL_D_MULTIPLE, KERNEL_D_MAX = 32, 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"flash_attention": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: `csrc/flash_attention.cu`, built by nvcc at first launch
LIBRARY = NvccLibrary("flash_attention", Path(__file__).resolve().parent
                      / "csrc" / "flash_attention.cu", {
    # q, k, v, out, dtype, b, hq, hkv, sq, d, kv_valid, kv_offset, causal,
    # scale, (batch, head, seq) strides of q, k, v, out, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, ctypes.c_float) + (_LL,) * 12 + (_P,),
})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _resolve(q: Tensor, k: Tensor, v: Tensor, scale: Optional[float],
             kv_valid: Optional[int], kv_offset: Optional[int]
             ) -> Tuple[float, int, int]:
    """Check the shapes (any device) and fill the defaults."""
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
    if not 1 <= kv_valid <= skv:
        raise ValueError(f"kv_valid={kv_valid} outside [1, Skv={skv}]")
    return (d ** -0.5 if scale is None else float(scale)), kv_valid, kv_offset


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          kv_valid: Optional[int] = None,
                          kv_offset: Optional[int] = None) -> Tensor:
    """The kernel's function in plain torch: q, k and v upcast to f32, q
    scaled, the mask selected to -1e30, an f32 softmax, the output in q's
    dtype.  Keys at or past ``kv_valid`` are left out, as the kernel never
    loads them."""
    scale, kv_valid, kv_offset = _resolve(q, k, v, scale, kv_valid,
                                          kv_offset)
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d) * scale
    kf = k[:, :, :kv_valid].float()
    vf = v[:, :, :kv_valid].float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    if causal:
        qpos = torch.arange(sq, device=q.device) + kv_offset
        kpos = torch.arange(kv_valid, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype)


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
        if t.stride(-1) != 1 or t.data_ptr() % (4 * t.element_size()) \
                or any(s % 4 for s, n in zip(t.stride()[:3], t.shape[:3])
                       if n > 1):
            raise ValueError("flash_attention kernel takes tensors with a "
                             "contiguous D axis, strides that are multiples "
                             "of 4 elements, and 4-element-aligned data")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    scale: Optional[float] = None,
                    kv_valid: Optional[int] = None,
                    kv_offset: Optional[int] = None) -> Tensor:
    """Attention of q (B, Hq, Sq, D) over k/v (B, Hkv, Skv, D); returns
    (B, Hq, Sq, D) in q's dtype, laid out in memory as q is."""
    scale, kv_valid, kv_offset = _resolve(q, k, v, scale, kv_valid,
                                          kv_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_valid=kv_valid, kv_offset=kv_offset)
    _check(q, k, v)
    out = torch.empty_like(q)          # q's strides, D contiguous
    b, hq, sq, d = q.shape
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        LIBRARY.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], b,
                       hq, k.shape[1], sq, d, kv_valid, kv_offset,
                       int(causal), scale, *strides,
                       torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention"] += 1
    return out
