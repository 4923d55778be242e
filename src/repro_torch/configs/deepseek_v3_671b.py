"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H d_ff=2048(expert) vocab=129280  [arXiv:2412.19437]
First 3 layers dense (d_ff 18432); MTP is implemented as an optional extra
prediction head (depth 1) — enabled in training via mtp_weight.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek_v3_671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18_432,
    vocab_size=129_280, mlp_act="swiglu", norm="rmsnorm",
    rope_theta=10_000.0, max_seq_len=32_769,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_rope_head_dim=64,
                  qk_nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_dense_layers=3),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, max_seq_len=64,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
                      qk_nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, first_dense_layers=1))
