"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352
[hf:databricks/dbrx-base]
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx_132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100_352, mlp_act="swiglu", norm="layernorm",
    rope_theta=500_000.0, max_seq_len=32_769,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10_752),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab_size=256, max_seq_len=64,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128))
