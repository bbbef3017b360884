"""hpmdr-field — the paper's own workload: refactor/retrieve scientific
fields.  Not an LM; used by benchmarks and the quickstart example.  The
"config" records the dataset proxies (paper Table 1)."""
from repro_torch.configs.base import ModelConfig

# placeholder ModelConfig so the registry stays uniform; the real knobs live
# in repro_torch.data.fields.DATASETS and core.lossless.HybridConfig.
CONFIG = ModelConfig(
    name="hpmdr-field", family="field",
    n_layers=0, d_model=0, n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=0,
)
SMOKE = CONFIG
