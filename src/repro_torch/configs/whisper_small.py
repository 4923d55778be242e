"""whisper-small [audio]: enc-dec, conv frontend stubbed to frame embeddings.

12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865  [arXiv:2212.04356]
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper_small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51_865, mlp_act="gelu", norm="layernorm", pos_emb="learned",
    max_seq_len=32_769, encoder=EncoderConfig(n_layers=12, n_frames=1500),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, max_seq_len=64,
        encoder=EncoderConfig(n_layers=2, n_frames=24))
