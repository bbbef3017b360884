"""deepseek-67b — dense llama-arch, GQA kv=8 [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400,
    rope_theta=10000.0, param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512, compute_dtype="float32",
)
