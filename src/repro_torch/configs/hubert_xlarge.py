"""hubert-xlarge — encoder-only audio transformer; the conv feature frontend
is a stub (input_specs supplies precomputed frame embeddings)
[arXiv:2106.07447; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    norm="layernorm", encoder_only=True, external_embed=True,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=64,
    norm="layernorm", encoder_only=True, external_embed=True,
    compute_dtype="float32",
)
