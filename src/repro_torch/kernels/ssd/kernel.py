"""Wrapper of the Hopper SSD chunk kernel (`csrc/ssd.cu`) and its plain version.

Port of `repro.kernels.ssd.kernel`.  The within-chunk work of the chunked
SSD: per (batch-head, chunk of Q steps) the intra-chunk output
``y_intra = ((C B^T) ∘ M) xdt`` with ``M[t, s] = exp(l_t - l_s)`` for
``s <= t`` (``l`` = inclusive cumsum of ``adt`` over the chunk), and the
chunk's end state ``B^T (xdt · exp(l_{Q-1} - l_s))``.  The cross-chunk
recurrence is plain torch in `ops.py`, as the reference does it in jnp.

B and C come per group of heads: ``heads_per_group`` consecutive heads
share one (S, N) slice of B and C (Mamba-2's ``n_groups``), so the kernel
forms each chunk's ``C B^T`` once for all of them.  ``heads_per_group = 1``
is the reference's interface, B and C per head.

`ssd_chunk` on a CUDA tensor launches the kernel (building the library at
first use) or raises; on a CPU tensor it runs `ssd_chunk_plain`.  There is
no fallback from the kernel to the plain version.  `LAUNCHES` counts kernel
launches, one per call that launched.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import NvccLibrary

Tensor = torch.Tensor

DEFAULT_CHUNK = 128
#: what `csrc/ssd.cu` takes: head width P, state width N % 32 up to N_MAX,
#: chunk Q % 64 up to Q_MAX (its shared-memory plan)
KERNEL_P, KERNEL_N_MULTIPLE, KERNEL_Q_MULTIPLE = 64, 32, 64
KERNEL_N_MAX, KERNEL_Q_MAX = 128, 256

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"ssd_chunk": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
#: `csrc/ssd.cu`, built by nvcc at first launch
LIBRARY = NvccLibrary("ssd", Path(__file__).resolve().parent / "csrc"
                      / "ssd.cu", {
    # xdt, adt, B, C, y, states, bh, s, q, p, n, heads_per_group, stream
    "ssd_chunk_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P),
})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tf32_round(x: Tensor) -> Tensor:
    """f32 values rounded to TF32 (10 explicit mantissa bits): the 13 low
    mantissa bits dropped, rounding to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does.  What one TF32 tensor-core pass sees of an f32
    operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def ssd_chunk_plain(xdt: Tensor, adt: Tensor, B: Tensor, C: Tensor, *,
                    chunk: int = DEFAULT_CHUNK, heads_per_group: int = 1,
                    tf32_operands: bool = False) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain torch (batched matmuls per chunk), on
    B and C repeated to every head of their group.

    ``tf32_operands`` rounds the operands of each of the three products to
    TF32 first (`tf32_round`): one TF32 tensor-core pass, the control that
    the kernel's f32-accurate products are held against."""
    bh, s, p = xdt.shape
    n = B.shape[-1]
    nc = s // chunk
    r = tf32_round if tf32_operands else (lambda t: t)
    x = xdt.float().reshape(bh, nc, chunk, p)
    Bc = B.float().repeat_interleave(heads_per_group, 0).reshape(
        bh, nc, chunk, n)
    Cc = C.float().repeat_interleave(heads_per_group, 0).reshape(
        bh, nc, chunk, n)
    l = torch.cumsum(adt.float().reshape(bh, nc, chunk), dim=-1)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xdt.device).tril()
    m = torch.where(mask, torch.exp(l[..., :, None] - l[..., None, :]), 0.0)
    y = r((r(Cc) @ r(Bc).transpose(-1, -2)) * m) @ r(x)
    decay_end = torch.exp(l[..., -1:] - l)[..., None]
    states = r(Bc).transpose(-1, -2) @ r(x * decay_end)
    return y.reshape(bh, s, p), states


def _check(xdt: Tensor, adt: Tensor, B: Tensor, C: Tensor, chunk: int,
           heads_per_group: int = 1) -> None:
    """Validate what the kernel takes; raise on anything else."""
    bh, s, p = xdt.shape
    n = B.shape[-1]
    if heads_per_group < 1 or bh % heads_per_group:
        raise ValueError(f"ssd_chunk: heads_per_group={heads_per_group} does "
                         f"not divide BH={bh}")
    g = bh // heads_per_group
    for t, shape in ((xdt, (bh, s, p)), (adt, (bh, s)), (B, (g, s, n)),
                     (C, (g, s, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk: shape {tuple(t.shape)}, want "
                             f"{shape}")
        if t.device != xdt.device:
            raise ValueError(f"tensors on {t.device} and {xdt.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("ssd_chunk takes contiguous float32 tensors")
        if t.data_ptr() % 16:
            raise ValueError("ssd_chunk takes 16-byte aligned tensors")
    if (p != KERNEL_P or n % KERNEL_N_MULTIPLE or n > KERNEL_N_MAX
            or chunk % KERNEL_Q_MULTIPLE or chunk > KERNEL_Q_MAX
            or bh > (1 << 24) or s // chunk > 65535):
        raise ValueError(
            f"ssd_chunk kernel takes P == {KERNEL_P}, N % "
            f"{KERNEL_N_MULTIPLE} == 0 and N <= {KERNEL_N_MAX}, chunk % "
            f"{KERNEL_Q_MULTIPLE} == 0 and chunk <= {KERNEL_Q_MAX}; got "
            f"P={p}, N={n}, chunk={chunk}, BH={bh}")


def ssd_chunk(xdt: Tensor, adt: Tensor, B: Tensor, C: Tensor, *,
              chunk: int = DEFAULT_CHUNK, heads_per_group: int = 1
              ) -> Tuple[Tensor, Tensor]:
    """Per-chunk intra outputs and chunk states.

    xdt (BH, S, P), adt (BH, S), B/C (BH / heads_per_group, S, N): head i
    reads group i // heads_per_group; S % chunk == 0.
    Returns y_intra (BH, S, P), states (BH, NC, N, P), both f32.
    """
    bh, s, p = xdt.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    if xdt.device.type == "cpu":
        return ssd_chunk_plain(xdt, adt, B, C, chunk=chunk,
                               heads_per_group=heads_per_group)
    _check(xdt, adt, B, C, chunk, heads_per_group)
    y = torch.empty((bh, s, p), dtype=torch.float32, device=xdt.device)
    states = torch.empty((bh, s // chunk, n, p), dtype=torch.float32,
                         device=xdt.device)
    with torch.cuda.device(xdt.device):
        LIBRARY.launch("ssd_chunk_launch", xdt.data_ptr(), adt.data_ptr(),
                       B.data_ptr(), C.data_ptr(), y.data_ptr(),
                       states.data_ptr(), bh, s, chunk, p, n,
                       heads_per_group,
                       torch.cuda.current_stream(xdt.device).cuda_stream)
    LAUNCHES["ssd_chunk"] += 1
    return y, states
