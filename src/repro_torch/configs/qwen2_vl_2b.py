"""qwen2-vl-2b [vlm]: M-RoPE, dynamic resolution (frontend stubbed).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191]
The vision tower is a stub: input_specs() provides precomputed patch/text
embeddings (B, S, d) plus 3-axis M-RoPE position ids.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151_936, mlp_act="swiglu", norm="rmsnorm", pos_emb="mrope",
    mrope_sections=(16, 24, 24), qkv_bias=True, tie_embeddings=True,
    embeds_input=True, rope_theta=1_000_000.0, max_seq_len=32_769,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, mrope_sections=(4, 2, 2),
                          max_seq_len=64)
