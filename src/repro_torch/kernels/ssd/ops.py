"""Public SSD entry points: chunked scan (prefill) + decode step.

Port of `repro.kernels.ssd.ops`.  Composition:
  1. kernel: per-chunk intra output + chunk states      (`kernel.ssd_chunk`)
  2. torch:  cross-chunk recurrence H_c = exp(Ltot_c) H_{c-1} + S_c
  3. torch:  y += (C · exp(l)) @ H_prev, the inter-chunk term
Steps 2 and 3 are plain torch, as the reference does them in jnp outside
Pallas; the recurrence is a loop over chunks (the reference's associative
scan associates the same products differently: equal up to rounding).

B and C may come per group: a head axis of G for any G that divides H
(head h reads group h // (H / G)); G = H is the reference's layout.  `ssd`
hands the groups to the kernel as they are, `ssd_chunked` repeats them to
the heads.

The kernel has no backward, as the reference's `pallas_call` has no VJP:
`ssd` calls it through an autograd function whose backward raises, and
training takes `ssd_chunked` (``use_kernel=False``), as the reference
trains through ``ssd_chunked_jnp``.  `ssd_chunked` masks the intra-chunk
decays before their exponent where the reference masks after it: the same
values, and a finite gradient where the reference's exponent overflows
above the diagonal (its gradient is NaN there at chunk 256 with dt near
0.7, the reference's initial dt).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import NO_BACKWARD
from repro_torch.kernels.ssd import kernel as _k
from repro_torch.kernels.ssd import ref as _ref

Tensor = torch.Tensor


class _SsdChunk(torch.autograd.Function):
    """`kernel.ssd_chunk` forward; a backward raises (no backward kernel)."""

    @staticmethod
    def forward(ctx, xdt, adt, B, C, chunk, heads_per_group):
        return _k.ssd_chunk(xdt, adt, B, C, chunk=chunk,
                            heads_per_group=heads_per_group)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(NO_BACKWARD.format("ssd_chunk"))


def _pad_seq(pad: int, *ts: Tensor) -> Tuple[Tensor, ...]:
    """Zero-pad dim 1 (the sequence) of each tensor by ``pad`` steps.  dt = 0
    on a padded step makes it the identity: exp(0) h + 0 = h."""
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ts)


def _chunk_recurrence(decay: Tensor, states: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """H_c = decay_c · H_{c-1} + S_c along dim 1, from H_{-1} = 0.

    ``decay`` broadcasts against ``states`` (trailing singleton dims).
    Returns (the state entering each chunk, the state after the last)."""
    h = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(states.shape[1]):
        entering.append(h)
        h = decay[:, c] * h + states[:, c]
    return torch.stack(entering, dim=1), h


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, *,
                chunk: int = _k.DEFAULT_CHUNK,
                return_final_state: bool = False):
    """Chunked SSD in plain torch, head axis explicit throughout (counterpart
    of `ssd_chunked_jnp`).  Same layouts and returns as :func:`ssd`; B and C
    are repeated from their groups to the heads first."""
    b, s, h, p = x.shape
    hpg = _heads_per_group(h, B, C)
    if hpg > 1:
        B, C = (t.repeat_interleave(hpg, dim=2) for t in (B, C))
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = _pad_seq(pad, x, dt, B, C)
    sp = s + pad
    nc = sp // chunk

    def r(t):  # (B, S, H, ...) -> (B, NC, Q, H, ...)
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xdt = r((x * dt[..., None]).float())                      # (b,c,q,h,p)
    adt = r((dt * A[None, None, :]).float())                  # (b,c,q,h)
    Br, Cr = r(B.float()), r(C.float())

    l = torch.cumsum(adt, dim=2)                              # (b,c,q,h)
    lt = l[:, :, :, None, :]                                  # (b,c,q,1,h)
    ls = l[:, :, None, :, :]                                  # (b,c,1,k,h)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()                 # (q,k) s<=t
    # masked before the exponent: above the diagonal l_t - l_s > 0 sums up
    # to a chunk of |dt A| and overflows f32 at long chunks (256 of dt near
    # 0.7), where exp(...) then 0 would give 0 * inf = NaN in backward
    m = torch.exp(torch.where(mask[None, None, :, :, None], lt - ls,
                              float("-inf")))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cr, Br)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores * m, xdt)

    decay_end = torch.exp(l[:, :, -1:, :] - l)                # (b,c,q,h)
    states = torch.einsum("bckhn,bckhp->bchnp", Br,
                          xdt * decay_end[..., None])
    decay = torch.exp(l[:, :, -1, :])[..., None, None]        # (b,c,h,1,1)
    h_prev, h_last = _chunk_recurrence(decay, states)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Cr * torch.exp(l)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s].to(x.dtype)
    if return_final_state:
        return y, h_last                                      # (b,h,n,p)
    return y


def _heads_per_group(h: int, B: Tensor, C: Tensor) -> int:
    g = B.shape[2]
    if C.shape != B.shape or g < 1 or h % g:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} need a "
                         f"group axis that divides H={h}")
    return h // g


def ssd(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, *,
        chunk: int = _k.DEFAULT_CHUNK, use_kernel: Optional[bool] = None,
        return_final_state: bool = False):
    """Chunked SSD.  x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N) with G
    dividing H (head h reads group h // (H / G); G = H: one per head).

    With return_final_state, also returns h_final (B,H,N,P) for decode.
    use_kernel: None = `kernel.ssd_chunk` on CUDA tensors, `ssd_chunked`
    on CPU ones; True = `kernel.ssd_chunk` (which runs its plain version on
    CPU tensors; a gradient through it raises); False = `ssd_chunked`."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return ssd_chunked(x, dt, A, B, C, chunk=chunk,
                           return_final_state=return_final_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    hpg = _heads_per_group(h, B, C)
    g = h // hpg
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = _pad_seq(pad, x, dt, B, C)
    sp = s + pad
    nc = sp // chunk

    def flat(t):  # (B, S, K, *) -> (B*K, S, *), contiguous: a view when K = 1
        return t.transpose(1, 2).reshape(-1, sp, *t.shape[3:]).contiguous()

    xdt = flat((x * dt[..., None]).float())
    adt = flat((dt * A[None, None, :]).float())
    Bf, Cf = flat(B.float()), flat(C.float())                # (B*G, S, N)

    y_intra, states = _SsdChunk.apply(xdt, adt, Bf, Cf, chunk, hpg)

    l = torch.cumsum(adt.reshape(b * h, nc, chunk), dim=-1)   # (BH,NC,Q)
    decay = torch.exp(l[..., -1])[..., None, None]            # (BH,NC,1,1)
    h_prev, h_last = _chunk_recurrence(decay, states)         # entering st.
    # y_inter[t] = exp(l_t) (C_t @ H_prev): one product per group, the heads
    # of the group side by side in its columns
    hg = h_prev.reshape(b * g, hpg, nc, n, p).permute(0, 2, 3, 1, 4)
    ch = Cf.reshape(b * g, nc, chunk, n) @ hg.reshape(b * g, nc, n, hpg * p)
    y_inter = ch.reshape(b * g, nc, chunk, hpg, p).permute(0, 3, 1, 2, 4) \
        .reshape(b * h, nc, chunk, p) * torch.exp(l)[..., None]
    y = y_intra.reshape(b * h, nc, chunk, p) + y_inter
    y = y.reshape(b, h, sp, p).transpose(1, 2)[:, :s].to(x.dtype)
    if return_final_state:
        # padded steps have dt = 0, so the last inclusive state is the state
        # after the real prefix
        return y, h_last.reshape(b, h, n, p)
    return y


def ssd_decode_step(hstate: Tensor, x: Tensor, dt: Tensor, A: Tensor,
                    B: Tensor, C: Tensor) -> Tuple[Tensor, Tensor]:
    """One-token decode: carries hstate (B,H,N,P), O(1) in context length."""
    return _ref.ssd_decode_ref(hstate, x, dt, A, B, C)
