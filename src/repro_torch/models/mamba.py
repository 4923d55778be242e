"""Mamba-2 (SSD) block: in_proj -> depthwise causal conv -> SSD -> gated out.

Port of `repro.models.mamba`, as an ``nn.Module``.  Weights keep the
reference's layouts (``in_proj`` (d, ·) applied as ``x @ W``, ``conv_w``
(K, C) as a cross-correlation), so `repro_torch.convert` copies them across
unchanged.  The dtype casts follow the reference step by step: ``x * dt``
is promoted to f32, the SSD output is cast to the model dtype before the
f32 ``D · x`` skip is added (prefill), and the gated RMSNorm runs on
``y · silu(z)`` cast to the model dtype.  Decode carries the conv window
and the SSM state: O(1) per token in context length.

In the sharded train and serving steps the mixer computes on the rank's
``"model"`` cut of its heads where the steps cut it
(`launch.shardings.model_cuts`, `models.tensor_parallel`; `Mamba2.forward`
under a cut): its input behind `launch.mesh.sum_grad`, ``in_proj``'s
columns of the rank's heads ``[z_r | x_r | B | C | dt_r]``
(`head_columns`; every rank takes all of B and C, the config's one
group), the conv on the rank's x channels and B and C, the SSD on its
heads, the gated RMSNorm's sum of squares all-reduced over ``"model"``
and ``out_proj`` a row product summed over ``"model"``.  The conv window
of a sharded serving cache holds the rank's channels only, the SSM state
its heads (`make_ssm_cache` with a mesh).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, upcast

Tensor = torch.Tensor

#: private test hooks, each of which must break the cut mixer:
#: "contiguous_in_proj" (``in_proj``'s columns taken at the rank's
#: contiguous block's offset, not its heads') and "local_norm" (the gated
#: norm over the rank's slice of d_inner alone)
_CONTROLS: frozenset = frozenset()


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    return di, s.n_groups, s.d_state, s.n_heads(cfg.d_model)


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype, device="cuda",
                   *, mesh=None, specs=None) -> dict:
    """An empty conv window and SSM state for ``batch`` rows; with
    ``mesh``, this rank's block of them under ``specs`` (``{"ssm",
    "conv"}``: `launch.shardings.cache_shardings`' specs of the whole
    leaves): the state (B, H, N, P) cut by its spec, the window's rows by
    its spec's batch entry and its channels the rank's x channels and
    every B and C channel where the state's heads are cut."""
    di, g, n, h = _dims(cfg)
    k = cfg.ssm.conv_kernel - 1
    if mesh is None:
        return {"conv": torch.zeros((batch, k, di + 2 * g * n),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((batch, h, n, cfg.ssm.head_dim),
                                   dtype=torch.float32, device=device),
                "len": 0}
    state = mesh_lib.block_shape((batch, h, n, cfg.ssm.head_dim),
                                 specs["ssm"], mesh)
    rows = mesh_lib.block_shape((batch, k, 1), specs["conv"], mesh)[0]
    return {"conv": torch.zeros((rows, k, di * state[1] // h + 2 * g * n),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(state, dtype=torch.float32, device=device),
            "len": 0}


def _spans(cfg: ModelConfig, parts: int, r: int):
    """((first, count) of ``in_proj``'s columns of rank ``r``'s heads of
    ``parts``: z, x, B and C, dt; (first, count) of its conv channels:
    x, B and C)."""
    di, g, n, h = _dims(cfg)
    dr, hr = di // parts, h // parts
    cols = ((r * dr, dr), (di + r * dr, dr), (2 * di, 2 * g * n),
            (2 * di + 2 * g * n + r * hr, hr))
    return cols, ((r * dr, dr), (di, 2 * g * n))


def _index(spans, device) -> Tensor:
    return torch.cat([torch.arange(a, a + c, device=device)
                      for a, c in spans])


def head_columns(cfg: ModelConfig, parts: int, r: int, device=None
                 ) -> Tensor:
    """The index of ``in_proj``'s columns of rank ``r``'s heads when they
    are cut in ``parts``: ``[z_r | x_r | B | C | dt_r]``."""
    return _index(_spans(cfg, parts, r)[0], device)


def _rank_in_proj(w: Tensor, cfg: ModelConfig, mesh) -> Tensor:
    """``in_proj``'s columns of this rank's heads from what the step
    handed the mixer: the placed columns themselves (serving), or the
    rank's contiguous block of its columns (training), all-gathered over
    ``"model"`` (its transpose through `launch.mesh.gather_summed`, so
    the backward hands each rank the summed gradient of its own block)
    and freed once the columns are taken."""
    parts, r = mesh.size("model"), mesh.index("model")
    di, g, n, h = _dims(cfg)
    width = 2 * di + 2 * g * n + h
    if w.shape[1] == 2 * (di // parts) + 2 * g * n + h // parts:
        return w
    if w.shape[1] != width // parts:
        raise ValueError(f"in_proj of {w.shape[1]} columns on a {parts}-way "
                         f"cut of {width}")
    w = mesh_lib.gather_summed(w.T, mesh, "model").T
    if "contiguous_in_proj" in _CONTROLS:
        first = min(r * width // parts,
                    width - (2 * di + h) // parts - 2 * g * n)
        return w[:, first:first + (2 * di + h) // parts + 2 * g * n]
    return w.index_select(1, head_columns(cfg, parts, r, w.device))


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
        ``use_kernel`` goes to `ops.ssd` (None: the kernel on CUDA).

        Where the sharded steps cut the mixer over ``"model"``
        (`tensor_parallel.cuts` selected a block of ``out_proj``, the
        rank's rows), it computes on the rank's heads (module docstring);
        the leaves whose specs keep them whole are sliced to those heads
        here, so their gradients are partial over ``"model"``."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, g, n, h = _dims(cfg)
        p = cfg.ssm.head_dim
        mesh = tp.mesh_of(self.out_proj)
        w_in, w_out = tp.block(self.in_proj), tp.block(self.out_proj)
        conv_w, conv_b, norm_w = self.conv_w, self.conv_b, self.norm_w
        A_log, D, dt_bias = self.A_log, self.D, self.dt_bias
        if mesh is not None:
            parts, r = mesh.size("model"), mesh.index("model")
            di, h = di // parts, h // parts
            x = mesh_lib.sum_grad(x, mesh, "model")  # column products' input
            w_in = _rank_in_proj(w_in, cfg, mesh)
            ch = _index(_spans(cfg, parts, r)[1], x.device)
            conv_w, conv_b = conv_w.index_select(1, ch), conv_b[ch]
            heads = slice(r * h, (r + 1) * h)
            A_log, D, dt_bias = A_log[heads], D[heads], dt_bias[heads]
            norm_w = norm_w[r * di:(r + 1) * di]
        z, xc, bc, cc, dt_raw = torch.split(
            x @ w_in, [di, di, g * n, g * n, h], dim=-1)
        conv_in = torch.cat([xc, bc, cc], dim=-1)
        conv_state = cache["conv"] if cache is not None else None
        conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_b,
                                          conv_state)
        xc = conv_out[..., :di]
        bc = conv_out[..., di:di + g * n]
        cc = conv_out[..., di + g * n:]

        xh = xc.reshape(b, s, h, p)
        # B and C stay per group (n_groups == 1 typical): `ssd` shares them
        # across the heads of a group
        bg = bc.reshape(b, s, g, n)
        cg = cc.reshape(b, s, g, n)
        dt = softplus(dt_raw.float() + dt_bias)               # (B,S,H)
        A = -torch.exp(A_log)                                 # (H,)

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

        y = y + D[None, None, :, None] * xh.float()
        y = y.reshape(b, s, di)
        # gated RMSNorm (mamba2): norm(y * silu(z))
        y = (y * F.silu(z.float())).to(x.dtype)
        if mesh is None:
            y = rmsnorm(y, norm_w, cfg.norm_eps)
            return y @ w_out, new_cache
        y = _cut_rmsnorm(y, norm_w, cfg.norm_eps, mesh, di * parts)
        # the row product's sum
        return mesh_lib.all_reduce_grad(y @ w_out, mesh, "model", ()), \
            new_cache


def _cut_rmsnorm(x: Tensor, weight: Tensor, eps: float, mesh, width: int
                 ) -> Tensor:
    """`rmsnorm` over ``width`` features of which this rank holds ``x``'s
    (its slice along ``"model"``): the squares summed in f32 (or wider)
    and all-reduced over ``"model"``, whose backward sums too, since every
    rank uses the total for its own features."""
    xf = upcast(x)
    sq = torch.sum(xf * xf, dim=-1, keepdim=True)
    if "local_norm" in _CONTROLS:
        width = x.shape[-1]
    else:
        sq = mesh_lib.all_reduce_grad(sq, mesh, "model", "model")
    out = xf * torch.rsqrt(sq / width + eps) * upcast(weight)
    return out.to(x.dtype)
