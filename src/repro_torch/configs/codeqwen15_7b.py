"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416 — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense", source="hf:Qwen/CodeQwen1.5-7B; hf",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416, qk_norm=False, rope_theta=1e6,
)
