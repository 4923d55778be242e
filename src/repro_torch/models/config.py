"""Unified model configuration covering the 10 assigned architectures.

The port's own copy of `repro.models.config` (pure dataclasses).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    every_k_layers: int = 1          # MoE on layers where idx % k == k-1
    first_dense_layers: int = 0      # deepseek: first N layers stay dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss
    overflow_policy: str = "cas_keep_top_gate"  # or "swp_drop_newest"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block dims."""
    d_state: int = 128
    head_dim: int = 64               # P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder half of an enc-dec model (whisper).  The modality frontend is
    a stub: input_specs() provides precomputed frame embeddings."""
    n_layers: int
    n_frames: int = 1500             # whisper 30s @ 50Hz after conv stub


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # blocks / activations
    mlp_act: str = "swiglu"          # swiglu | geglu | gelu | silu_glu(alias)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    parallel_residual: bool = False  # command-r style
    qkv_bias: bool = False           # qwen2
    mlp_bias: bool = False
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma: * sqrt(d_model)
    logit_softcap: float = 0.0
    # positions
    pos_emb: str = "rope"            # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # stablelm partial rotary
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # qwen2-vl halves
    max_seq_len: int = 131_072
    # structured sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid schedule (jamba): attention on layers where idx % period == offset
    attn_layer_period: int = 0       # 0 -> every layer is attention (or ssm-only)
    attn_layer_offset: int = 4
    # modality stub: model consumes precomputed embeddings instead of ids
    embeds_input: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # ---- layer schedule -------------------------------------------------
    def layer_kind(self, idx: int) -> str:
        """'attn' or 'ssm' for layer idx."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_layer_period:
            return ("attn" if idx % self.attn_layer_period == self.attn_layer_offset
                    else "ssm")
        return "attn"

    def layer_is_moe(self, idx: int) -> bool:
        if self.moe is None:
            return False
        if idx < self.moe.first_dense_layers:
            return False
        k = self.moe.every_k_layers
        return idx % k == (k - 1) if k > 1 else True

    def stages(self) -> Tuple[Tuple[str, int], ...]:
        """Group consecutive layers into scan-able stages of identical
        structure.  Returns ((signature, count), ...) preserving order, where
        signature = f"{kind}:{'moe' if moe else 'dense'}".  Periodic schedules
        (jamba) produce a repeating super-block handled by transformer.py."""
        sigs = [f"{self.layer_kind(i)}:{'moe' if self.layer_is_moe(i) else 'dense'}"
                for i in range(self.n_layers)]
        out = []
        for s in sigs:
            if out and out[-1][0] == s:
                out[-1][1] += 1
            else:
                out.append([s, 1])
        return tuple((a, b) for a, b in out)

    def replace(self, **kw) -> "ModelConfig":
        if "head_dim" not in kw and ("d_model" in kw or "n_heads" in kw):
            kw["head_dim"] = 0  # recompute from the new dims (__post_init__)
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for roofline MODEL_FLOPS) ---------------------
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "ssm":
                assert self.ssm is not None
                di = self.ssm.d_inner(d)
                g = self.ssm.n_groups
                n = self.ssm.d_state
                h = self.ssm.n_heads(d)
                inproj = d * (2 * di + 2 * g * n + h)
                conv = (di + 2 * g * n) * self.ssm.conv_kernel
                total += inproj + conv + h + di * d + di  # +outproj +norm-ish
            else:
                if self.mla is not None:
                    m = self.mla
                    h = self.n_heads
                    total += d * m.q_lora_rank \
                        + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim) \
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim) \
                        + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) \
                        + h * m.v_head_dim * d
                else:
                    hd = self.head_dim
                    total += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                        + (self.n_heads * hd) * d
            # mlp
            mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            if self.layer_is_moe(i):
                assert self.moe is not None
                total += self.moe.n_experts * mult * d * self.moe.d_ff_expert
                total += self.moe.n_shared_experts * mult * d * self.moe.d_ff_expert
                total += d * self.moe.n_experts  # router
            elif kind != "ssm":
                total += mult * d * self.d_ff
            total += 2 * d  # norms
        if self.encoder is not None:
            mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
            per = 4 * d * d + mult * d * self.d_ff + 2 * d
            # decoder cross-attn adds ~4 d^2 per decoder layer
            total += self.encoder.n_layers * per + self.n_layers * 4 * d * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        all_experts = n_moe_layers * m.n_experts * mult * self.d_model * m.d_ff_expert
        active = n_moe_layers * m.top_k * mult * self.d_model * m.d_ff_expert
        return int(full - all_experts + active)
