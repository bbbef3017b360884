"""llama-3.2-vision-90b — text backbone with gated cross-attention image
layers every 5th layer; vision frontend is a stub (input_specs supplies
pre-projected patch embeddings) [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    cross_attn_period=5, n_vision_tokens=1601,
    rope_theta=500000.0, param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=5, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    cross_attn_period=5, n_vision_tokens=17,
    compute_dtype="float32",
)
