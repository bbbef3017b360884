"""repro_torch.ckpt — the exact bitplane codec (``bitcast_codec``: float32,
bfloat16, float16, int32 and float64 tensors, bit-exact in full and
relative-error-bounded in prefix) and the checkpoint manager built on it
(``manager``: atomic, async, partial loads), ports of ``repro.ckpt``."""
