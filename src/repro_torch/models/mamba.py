"""Mamba-2 (SSD) block: in_proj -> depthwise causal conv -> SSD -> gated out.

Port of `repro.models.mamba`, as an ``nn.Module``.  Weights keep the
reference's layouts (``in_proj`` (d, ·) applied as ``x @ W``, ``conv_w``
(K, C) as a cross-correlation), so `repro_torch.convert` copies them across
unchanged.  The dtype casts follow the reference step by step: ``x * dt``
is promoted to f32, the SSD output is cast to the model dtype before the
f32 ``D · x`` skip is added (prefill), and the gated RMSNorm runs on
``y · silu(z)`` cast to the model dtype.  Decode carries the conv window
and the SSM state: O(1) per token in context length.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm

Tensor = torch.Tensor


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    return di, s.n_groups, s.d_state, s.n_heads(cfg.d_model)


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype, device="cuda"
                   ) -> dict:
    di, g, n, h = _dims(cfg)
    conv_ch = di + 2 * g * n
    return {"conv": torch.zeros((batch, cfg.ssm.conv_kernel - 1, conv_ch),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, h, n, cfg.ssm.head_dim),
                               dtype=torch.float32, device=device),
            "len": 0}


def softplus(x: Tensor) -> Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it (logaddexp(x, 0)), with
    no linear branch above a threshold as `F.softplus` has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(seq: Tensor, w: Tensor, b: Tensor, state: Optional[Tensor]
                 ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv over (B, S, C); returns (out, new window).

    out[t] = sum_k full[t + k] * w[k] + b over ``full`` = state ++ seq,
    summed in f32 and rounded once to the input dtype."""
    kk = w.shape[0]
    if state is None:
        state = seq.new_zeros((seq.shape[0], kk - 1, seq.shape[2]))
    full = torch.cat([state, seq], dim=1)                  # (B, K-1+S, C)
    s = seq.shape[1]
    wf = w.float()
    acc = full[:, 0:s].float() * wf[0]
    for i in range(1, kk):
        acc = acc + full[:, i:i + s].float() * wf[i]
    out = acc.to(seq.dtype) + b
    return F.silu(out), full[:, -(kk - 1):, :]


class Mamba2(nn.Module):
    """One Mamba-2 mixer (`mamba_init` + `mamba_forward` of the reference)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype):
        super().__init__()
        self.cfg = cfg
        s = cfg.ssm
        d = cfg.d_model
        di, g, n, h = _dims(cfg)
        conv_ch = di + 2 * g * n
        dev = gen.device
        f32 = torch.float32
        self.in_proj = nn.Parameter(
            dense_init(gen, d, 2 * di + 2 * g * n + h, dtype))
        self.conv_w = nn.Parameter(
            (torch.randn((s.conv_kernel, conv_ch), generator=gen, device=dev)
             * 0.2).to(dtype))
        self.conv_b = nn.Parameter(torch.zeros((conv_ch,), dtype=dtype,
                                               device=dev))
        # A = -exp(A_log) = -1
        self.A_log = nn.Parameter(torch.zeros((h,), dtype=f32, device=dev))
        self.D = nn.Parameter(torch.ones((h,), dtype=f32, device=dev))
        self.dt_bias = nn.Parameter(torch.zeros((h,), dtype=f32, device=dev))
        self.norm_w = nn.Parameter(torch.ones((di,), dtype=dtype, device=dev))
        self.out_proj = nn.Parameter(dense_init(gen, di, d, dtype))

    def forward(self, x: Tensor, cache: Optional[dict] = None, *,
                use_kernel: Optional[bool] = None
                ) -> Tuple[Tensor, Optional[dict]]:
        """x (B, S, d) -> (out (B, S, d), cache').  cache given => stateful.
        ``use_kernel`` goes to `ops.ssd` (None: the kernel on CUDA)."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, g, n, h = _dims(cfg)
        p = cfg.ssm.head_dim
        z, xc, bc, cc, dt_raw = torch.split(
            x @ self.in_proj, [di, di, g * n, g * n, h], dim=-1)
        conv_in = torch.cat([xc, bc, cc], dim=-1)
        conv_state = cache["conv"] if cache is not None else None
        conv_out, new_conv = _causal_conv(conv_in, self.conv_w, self.conv_b,
                                          conv_state)
        xc = conv_out[..., :di]
        bc = conv_out[..., di:di + g * n]
        cc = conv_out[..., di + g * n:]

        xh = xc.reshape(b, s, h, p)
        # B and C stay per group (n_groups == 1 typical): `ssd` shares them
        # across the heads of a group
        bg = bc.reshape(b, s, g, n)
        cg = cc.reshape(b, s, g, n)
        dt = softplus(dt_raw.float() + self.dt_bias)          # (B,S,H)
        A = -torch.exp(self.A_log)                            # (H,)

        if cache is not None and s == 1:
            # the decode step takes B and C per head: groups broadcast
            rep = h // g
            bh = bg.repeat_interleave(rep, dim=2)
            ch = cg.repeat_interleave(rep, dim=2)
            hstate, y = ssd_decode_step(
                cache["ssm"], xh[:, 0].float(), dt[:, 0], A,
                bh[:, 0].float(), ch[:, 0].float())
            y = y[:, None]                                    # (B,1,H,P)
            new_cache = {"conv": new_conv, "ssm": hstate,
                         "len": cache["len"] + 1}
        elif cache is not None:
            y, hstate = ssd(xh, dt, A, bg, cg, chunk=cfg.ssm.chunk,
                            use_kernel=use_kernel, return_final_state=True)
            new_cache = {"conv": new_conv, "ssm": hstate,
                         "len": cache["len"] + s}
        else:
            y = ssd(xh, dt, A, bg, cg, chunk=cfg.ssm.chunk,
                    use_kernel=use_kernel)
            new_cache = None

        y = y + self.D[None, None, :, None] * xh.float()
        y = y.reshape(b, s, di)
        # gated RMSNorm (mamba2): norm(y * silu(z))
        y = rmsnorm((y * F.silu(z.float())).to(x.dtype), self.norm_w,
                    cfg.norm_eps)
        return y @ self.out_proj, new_cache
