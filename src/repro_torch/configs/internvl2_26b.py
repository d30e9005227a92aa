"""internvl2-26b [vlm] — InternViT frontend (STUB: precomputed patch embeddings) +
InternLM2 backbone — arXiv:2404.16821 (hf)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553,
    mlp="swiglu", rope_theta=1000000.0, n_img_tokens=256,
))
