"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block — arXiv:2411.15242
(unverified).  Simplifications vs the released model (noted per DESIGN.md): one
shared transformer block applied every `attn_every` SSM layers with a concat
projection from [x, x_embed]; no per-application LoRA."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    mlp="gelu", rope_theta=10000.0,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
    attn_every=6, sub_quadratic=True,
))
