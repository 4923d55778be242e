"""Plain-torch oracle for the Mamba-2 SSD (state-space duality) scan.

Port of `repro.kernels.ssd.ref`.  The sequential recurrence (the definition,
arXiv:2405.21060 §3):
    h_t = exp(A * dt_t) * h_{t-1} + dt_t * (B_t ⊗ x_t)     h: (N, P)
    y_t = C_t^T h_t
Layouts: x (B, S, H, P), dt (B, S, H), A (H,), B/C (B, S, H, N).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def ssd_ref(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor
            ) -> Tensor:
    """y (B, S, H, P) in ``x.dtype``, one time step at a time in f32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    hstate = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        hstate, y = ssd_decode_ref(hstate, xf[:, t], dtf[:, t], A.float(),
                                   Bf[:, t], Cf[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_decode_ref(hstate: Tensor, x: Tensor, dt: Tensor, A: Tensor,
                   B: Tensor, C: Tensor) -> Tuple[Tensor, Tensor]:
    """One decode step.  hstate (B,H,N,P), x (B,H,P), dt (B,H), B/C (B,H,N)."""
    decay = torch.exp(A[None, :] * dt)[..., None, None]
    hstate = decay * hstate + dt[..., None, None] * torch.einsum(
        "bhn,bhp->bhnp", B, x)
    y = torch.einsum("bhn,bhnp->bhp", C, hstate)
    return hstate, y
