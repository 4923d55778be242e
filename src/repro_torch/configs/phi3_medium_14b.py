"""phi3-medium-14b [dense]: RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352 [arXiv:2404.14219]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3_medium_14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17_920,
    vocab_size=100_352, mlp_act="swiglu", norm="rmsnorm",
    max_seq_len=32_769,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                          d_ff=128, vocab_size=256, max_seq_len=64)
