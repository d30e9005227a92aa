"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free — arXiv:2405.21060
(unverified)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
    sub_quadratic=True,
))
