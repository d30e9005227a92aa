"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b (unverified)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352,
    mlp="swiglu", rope_theta=10000.0,
))
