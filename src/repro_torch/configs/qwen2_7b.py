"""qwen2-7b — GQA kv=4 with QKV bias [arXiv:2407.10671; hf].

28 query heads do not divide the 16-way model axis; the sharding policy keeps
attention head-local and uses the model axis for extra data/sequence
parallelism (the reference's launch/policy.py)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=112, n_heads=7, n_kv_heads=1,
    d_ff=224, vocab_size=512, qkv_bias=True, compute_dtype="float32",
)
