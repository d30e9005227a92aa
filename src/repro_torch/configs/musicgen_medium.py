"""musicgen-medium [audio] — decoder-only over EnCodec tokens (4 codebooks; frontend
STUB provides codebook token ids) — arXiv:2306.05284 (hf)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048,
    mlp="gelu", rope_theta=10000.0, n_codebooks=4,
))
