"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    moe_experts=128, moe_top_k=8,
)
