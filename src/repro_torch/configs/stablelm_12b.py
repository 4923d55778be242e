"""stablelm-12b [dense]: partial rotary, layernorm.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-12b]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13_824,
    vocab_size=100_352, mlp_act="swiglu", norm="layernorm",
    rope_fraction=0.25, max_seq_len=32_769,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, max_seq_len=64)
