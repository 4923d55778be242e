"""Public attention entry points: the standalone op and the kernel on any
head width.

Port of `repro.kernels.flash_attention.ops`.  The Pallas kernel needs Sq and
Skv padded to block multiples; the CUDA kernel masks the tails of Sq and Skv
itself, so nothing is padded along the sequence.  It takes D % 32 == 0, so
`flash` pads the head width with zero columns (which add nothing to q·k and
give zero output columns, sliced off) and passes the scale of the real D.

The kernel has no backward, as the reference's `pallas_call` has no VJP:
`flash` is an autograd function whose backward raises.  Training takes
the plain attention math (`models.attention._sdpa` with
``use_kernel=False``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import NO_BACKWARD
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


class _Flash(torch.autograd.Function):
    """The kernel forward; a backward raises (no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_valid, kv_offset):
        return _k.flash_attention(q, k, v, causal=causal, scale=scale,
                                  kv_valid=kv_valid, kv_offset=kv_offset)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(NO_BACKWARD.format("flash_attention"))


def flash(q, k, v, *, causal: bool, scale: Optional[float], kv_valid: int,
          kv_offset: int):
    """`kernel.flash_attention` for any D <= 256 (zero-padded to a multiple
    of 32).  Layouts as the kernel's: q (B, Hq, Sq, D), k/v (B, Hkv, Skv,
    D), any strides.  v's width must be D: a model with another value
    width (MLA) runs the plain math.  A gradient through it raises."""
    d = q.shape[-1]
    if k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"the flash kernel takes one head width: q {d}, "
                         f"k {k.shape[-1]}, v {v.shape[-1]}; Dv != D (MLA) "
                         f"runs the plain attention math")
    scale = d ** -0.5 if scale is None else scale
    pad = (-d) % _k.KERNEL_D_MULTIPLE
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    out = _Flash.apply(q, k, v, causal, scale, kv_valid, kv_offset)
    return out[..., :d] if pad else out


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              use_kernel: bool = True):
    """Flash attention of q (B, Hq, Sq, D) over k/v (B, Hkv, Skv, D).

    use_kernel: True = `kernel.flash_attention` (the CUDA kernel on CUDA
    tensors, its plain version on CPU ones), with every key valid and the
    causal diagonal anchored at ``Skv - Sq``; False = `ref.attention_ref`."""
    if not use_kernel:
        return _ref.attention_ref(q, k, v, causal=causal, scale=scale)
    sq, skv = q.shape[2], k.shape[2]
    return flash(q, k, v, causal=causal, scale=scale, kv_valid=skv,
                 kv_offset=skv - sq)
