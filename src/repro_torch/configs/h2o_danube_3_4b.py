"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    attn_window=4096,  # mistral-style SWA -> long_500k decode is O(window)
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="danube3-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, attn_window=64, compute_dtype="float32",
)
