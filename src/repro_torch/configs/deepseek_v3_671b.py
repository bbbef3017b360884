"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,  # dense layers' FFN
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  first_dense=3),
    mtp_depth=1,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="dsv3-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  first_dense=1, capacity_factor=4.0),  # drop-free at smoke T
    mtp_depth=1,
    compute_dtype="float32",
)
