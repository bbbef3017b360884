"""deepseek-v2-236b — MLA (kv_lora=512), MoE 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,  # dense first layer FFN
    vocab_size=102400,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_dense=1),
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="dsv2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    # capacity_factor=4.0 makes cap == T at smoke sizes, so no token is ever
    # capacity-dropped (each token contributes <= 1 assignment per expert) and
    # prefill+decode is numerically consistent with the full forward.
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  first_dense=1, capacity_factor=4.0),
    compute_dtype="float32",
)
