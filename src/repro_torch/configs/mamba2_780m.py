"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060]
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280, head_dim=1, norm="rmsnorm", pos_emb="none",
    tie_embeddings=True, max_seq_len=524_289,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, vocab_size=256, max_seq_len=128,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16))
