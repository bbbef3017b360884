"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2 every other
layer [arXiv:2403.19887; hf].

Period-8 block: attention at offset 4 (1:7 ratio), MoE on odd layers."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    ssm=SSMConfig(kind="mamba", d_state=16, expand=2, dt_rank=256,
                  conv_width=4, attn_period=8, attn_offset=4),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, layer_period=2),
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    ssm=SSMConfig(kind="mamba", d_state=8, expand=2, dt_rank=8,
                  conv_width=4, attn_period=8, attn_offset=4),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, layer_period=2,
                  capacity_factor=2.0),  # cap == T at smoke T (k/E = 1/2)
    compute_dtype="float32",
)
