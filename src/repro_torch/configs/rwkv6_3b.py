"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
— Finch: data-dependent decay [arXiv:2404.05892; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", source="arXiv:2404.05892; hf",
    n_layers=32, d_model=2560, d_ff=8960, vocab_size=65536,
    ssm_head_dim=64, rwkv_decay_lora=64, subquadratic=True,
)
