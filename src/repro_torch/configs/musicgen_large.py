"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec frontend is a stub per the assignment: ``input_specs()``
supplies the 4-codebook token ids the decoder consumes."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", source="arXiv:2306.05284; hf",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, rope_theta=1e4,
    n_codebooks=4,
)
