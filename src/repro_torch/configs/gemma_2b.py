"""gemma-2b [dense]: GeGLU, head_dim=256, MQA, tied + scaled embeddings.

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000 [arXiv:2403.08295]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma_2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16_384,
    vocab_size=256_000, head_dim=256, mlp_act="geglu", norm="rmsnorm",
    tie_embeddings=True, scale_embeddings=True, max_seq_len=32_769,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=128, vocab_size=256,
                          max_seq_len=64)
