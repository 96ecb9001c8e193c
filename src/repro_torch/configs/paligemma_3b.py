"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma [arXiv:2407.07726; hf].

The SigLIP frontend is a stub per the assignment: ``input_specs()``
supplies precomputed patch embeddings (B, 256, 1152)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", source="arXiv:2407.07726; hf",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, rope_theta=1e4,
    vision_embed_dim=1152, n_patches=256, prefix_lm=True,
    logit_softcap=30.0, embed_scale=True,
)
