"""rwkv6-3b — Finch, data-dependent decay, attention-free [arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6"),
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    ssm=SSMConfig(kind="rwkv6"),
    norm="layernorm", compute_dtype="float32",
)
