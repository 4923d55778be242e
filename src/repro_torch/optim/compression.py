"""int8 error-feedback gradient compression (the cross-pod reduce's trick).

Port of `repro.optim.compression`.  A gradient (plus the error carried from
the last step) is quantized to int8 with one max-abs scale per block of
`BLOCK` values; the quantization error is fed back into the next step's
gradient, which keeps the scheme unbiased over time (Seide et al. 1-bit
SGD; Karimireddy et al. EF-SGD).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so payload and scales are bit-equal to the reference's
on the same input.  `compress_tree` works on a name-keyed dict of tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

BLOCK = 256


class Compressed(NamedTuple):
    q: Tensor          # int8 payload, the flat gradient padded to BLOCK
    scales: Tensor     # f32 per-block scales


def _pad_flat(x: Tensor) -> Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return F.pad(flat, (0, pad)) if pad else flat


def compress(grad: Tensor, error: Optional[Tensor] = None
             ) -> Tuple[Compressed, Tensor]:
    """Quantize grad + error to int8 with per-block max-abs scales.

    Returns (compressed, new_error) where new_error = (grad + error) -
    dequant is carried to the next step (error feedback), in grad's
    dtype."""
    g = grad.float()
    if error is not None:
        g = g + error.float()
    flat = _pad_flat(g)
    blocks = flat.reshape(-1, BLOCK)
    # a divisor on the device: CUDA multiplies by the reciprocal of a
    # host scalar, which is not the reference's division
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) \
        / torch.tensor(127.0, device=g.device)
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    dq = (q.float() * safe).reshape(-1)[:g.numel()].reshape(g.shape)
    new_error = g - dq
    return Compressed(q=q.reshape(-1), scales=safe[:, 0]), \
        new_error.to(grad.dtype)


def decompress(comp: Compressed, shape: Tuple[int, ...],
               dtype=torch.float32) -> Tensor:
    blocks = comp.q.reshape(-1, BLOCK).float() * comp.scales[:, None]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def wire_bytes(comp: Compressed) -> int:
    """Bytes on the wire for one compressed tensor (int8 + f32 scales)."""
    return comp.q.numel() + comp.scales.numel() * 4


def compress_tree(grads: Mapping[str, Tensor],
                  errors: Optional[Mapping[str, Tensor]]
                  ) -> Tuple[Dict[str, Compressed], Dict[str, Tensor]]:
    """Leaf-wise compression over a name-keyed gradient dict; ``errors``
    may be None (zero error everywhere)."""
    comp, errs = {}, {}
    for name, g in grads.items():
        err = torch.zeros_like(g) if errors is None else errors[name]
        comp[name], errs[name] = compress(g, err)
    return comp, errs
