"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA [arXiv:2403.17297; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense", source="arXiv:2403.17297; hf",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, qk_norm=False, rope_theta=1e6,
)
