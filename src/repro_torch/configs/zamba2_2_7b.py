"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", source="arXiv:2411.15242; hf",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, ssm_state=64, ssm_head_dim=64,
    ssm_expand=2, shared_attn_every=6, subquadratic=True,
)
