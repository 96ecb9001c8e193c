"""Architecture + shape configuration system (a copy of the reference's).

Every assigned architecture is a ``ModelConfig`` in
``repro_torch.configs.<id>``; ``--arch <id>`` resolves through
``repro_torch.configs.get_config``. Each config also provides a reduced
``smoke()`` variant of the same family for real CPU execution in tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "shape_for"]


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""            # provenance tag from the assignment table

    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0          # gemma-style; 0 = off
    embed_scale: bool = False           # gemma multiplies embeds by sqrt(d)

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / RWKV
    ssm_state: int = 0                  # mamba2 N
    ssm_head_dim: int = 64              # mamba2 P / rwkv head size
    ssm_expand: int = 2                 # mamba2 d_inner = expand * d_model
    ssm_conv_width: int = 4
    rwkv_decay_lora: int = 64

    # hybrid (zamba2)
    shared_attn_every: int = 6          # apply the shared block every N layers

    # audio (musicgen)
    n_codebooks: int = 0

    # vlm (paligemma)
    vision_embed_dim: int = 0           # SigLIP output width (stub frontend)
    n_patches: int = 0
    prefix_lm: bool = False

    # numerics / training
    dtype: str = "bfloat16"
    subquadratic: bool = False          # can run long_500k

    # ---------------------------------------------------------------- util
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config: runs one real step on CPU."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.family == "moe":
            kw.update(moe_experts=4, moe_top_k=2)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=8, ssm_head_dim=8, rwkv_decay_lora=8)
        if self.family == "hybrid":
            kw.update(shared_attn_every=2)
        if self.family == "audio":
            kw.update(n_codebooks=self.n_codebooks, vocab_size=64)
        if self.family == "vlm":
            kw.update(vision_embed_dim=24, n_patches=8, head_dim=16)
        return self.replace(**kw)

    # parameter count (for MODEL_FLOPS = 6 N D)
    def param_count(self, active_only: bool = False) -> int:
        d, ff, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "audio":
            emb = self.n_codebooks * v * d * 2
        if self.family == "vlm":
            emb += self.vision_embed_dim * d
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        mlp = 3 * d * ff
        if self.family == "moe":
            e = self.moe_top_k if active_only else self.moe_experts
            mlp = 3 * d * ff * e + d * self.moe_experts  # experts + router
        if self.family == "ssm":                          # rwkv6
            att_like = 4 * d * d + 2 * d * self.rwkv_decay_lora * 2
            mlp_like = 2 * d * ff
            return emb + L * (att_like + mlp_like)
        if self.family == "hybrid":                       # zamba2
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            shared = (2 * d) * d + attn + mlp             # projector + block
            return emb + L * mamba + shared
        per_layer = attn + mlp
        if self.family == "hybrid":
            per_layer = mlp
        return emb + L * per_layer


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch      # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_for(name: str) -> ShapeSpec:
    try:
        return SHAPES[name]
    except KeyError as e:
        raise KeyError(f"unknown shape '{name}'; known: {sorted(SHAPES)}") from e
