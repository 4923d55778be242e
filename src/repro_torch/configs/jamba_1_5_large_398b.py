"""jamba-1.5-large-398b [hybrid]: Mamba+attn 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536  [arXiv:2403.19887]
Attention on layers where idx % 8 == 4; MoE every other layer.  The mamba
layers use our SSD (Mamba-2) blocks — a documented simplification
(DESIGN.md: Jamba ships Mamba-1; SSD is the TPU-native formulation).
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba_1_5_large_398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24_576,
    vocab_size=65_536, mlp_act="swiglu", norm="rmsnorm", pos_emb="none",
    max_seq_len=524_289,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24_576,
                  every_k_layers=2),
    attn_layer_period=8, attn_layer_offset=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, max_seq_len=128,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, every_k_layers=2),
        attn_layer_period=4, attn_layer_offset=2)
