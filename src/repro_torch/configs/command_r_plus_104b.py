"""command-r-plus-104b [dense]: parallel residual, no-bias, tied embeddings.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-plus]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command_r_plus_104b", family="dense",
    n_layers=64, d_model=12_288, n_heads=96, n_kv_heads=8, d_ff=33_792,
    vocab_size=256_000, mlp_act="swiglu", norm="layernorm",
    parallel_residual=True, tie_embeddings=True, rope_theta=75_000_000.0,
    max_seq_len=32_769,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, max_seq_len=64)
