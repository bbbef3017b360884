"""command-r-plus-104b — parallel attn+FFN blocks, LayerNorm, no bias, tied
embeddings [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    rope_theta=75000000.0, param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    norm="layernorm", parallel_block=True, tie_embeddings=True,
    compute_dtype="float32",
)
