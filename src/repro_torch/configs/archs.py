"""The 10 assigned architectures (+ reduced smoke variants).

Every full config matches the assignment table exactly; provenance is recorded
in ``source``.  Smoke variants keep the *family shape* (same layer pattern,
same block kinds, same ratios) at laptop scale.
"""
from __future__ import annotations

from .base import (
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RGLRUConfig,
    SSDConfig,
    register,
    register_smoke,
)

# ---------------------------------------------------------------------------
# MoE family
# ---------------------------------------------------------------------------


@register
def llama4_maverick() -> ModelConfig:
    # 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1,
    # iRoPE: 3 chunked-local layers (rope) : 1 global layer (nope).
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        pattern=("chunked", "chunked", "chunked", "global"),
        window=8192,
        nope_global=True,
        activation="swiglu",
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=128,
            top_k=1,
            d_ff_expert=8192,
            n_shared_experts=1,
            d_ff_shared=8192,
            moe_period=2,       # interleave_moe_layer_step=2 (odd layers MoE)
            d_ff_dense=16384,   # dense layers between MoE layers
        ),
        rope_theta=500000.0,
        source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
    )


@register
def deepseek_v2() -> ModelConfig:
    # 60L d_model=5120 128H d_ff=1536/expert vocab=102400,
    # MLA kv_lora=512, 2 shared + 160 routed top-6, first layer dense.
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=192,  # qk head dim = nope(128) + rope(64)
        d_ff=12288,
        vocab_size=102400,
        pattern=("global",),
        activation="swiglu",
        tie_embeddings=False,
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_experts=160,
            top_k=6,
            d_ff_expert=1536,
            n_shared_experts=2,
            d_ff_shared=2 * 1536,
            first_dense_layers=1,
            d_ff_dense=12288,
        ),
        source="[arXiv:2405.04434; hf]",
    )


# ---------------------------------------------------------------------------
# Hybrid / SSM family
# ---------------------------------------------------------------------------


@register
def recurrentgemma_2b() -> ModelConfig:
    # 26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000,
    # RG-LRU + local attn, pattern (rec, rec, local); 26 = 8*3 + 2.
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        pattern=("recurrent", "recurrent", "local"),
        pattern_tail=("recurrent", "recurrent"),
        window=2048,
        activation="geglu",
        rglru=RGLRUConfig(lru_width=2560, conv_width=4),
        source="[arXiv:2402.19427; hf]",
    )


@register
def mamba2_2p7b() -> ModelConfig:
    # 64L d_model=2560 attn-free, ssm_state=128, vocab=50280.
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=80,  # d_inner(5120) / head_dim(64)
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        pattern=("ssm",),
        ssd=SSDConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
        source="[arXiv:2405.21060; unverified]",
    )


# ---------------------------------------------------------------------------
# Dense family
# ---------------------------------------------------------------------------


@register
def gemma_7b() -> ModelConfig:
    # 28L d_model=3072 16H (MHA kv=16, head_dim=256) d_ff=24576 vocab=256000.
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        pattern=("global",),
        activation="geglu",
        source="[arXiv:2403.08295; hf]",
    )


@register
def qwen15_110b() -> ModelConfig:
    # 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        pattern=("global",),
        qkv_bias=True,
        activation="swiglu",
        tie_embeddings=False,
        emb_scale=False,
        rope_theta=1000000.0,
        source="[hf:Qwen/Qwen1.5-0.5B; hf]",
    )


@register
def gemma3_12b() -> ModelConfig:
    # 48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144,
    # 5 local : 1 global, 128k context, qk-norm, dual rope theta.
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        pattern=("local", "local", "local", "local", "local", "global"),
        window=1024,
        qk_norm=True,
        post_norms=True,
        activation="geglu",
        rope_theta=10000.0,
        rope_theta_global=1000000.0,
        source="[hf:google/gemma-3-1b-pt; unverified]",
    )


@register
def gemma2_2b() -> ModelConfig:
    # 26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000,
    # alternating local/global, logit softcap.
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        pattern=("local", "global"),
        window=4096,
        post_norms=True,
        logit_softcap=30.0,
        attn_softcap=50.0,
        activation="geglu",
        source="[arXiv:2408.00118; hf]",
    )


# ---------------------------------------------------------------------------
# Multimodal backbones (frontends are stubs per the assignment)
# ---------------------------------------------------------------------------


@register
def internvl2_2b() -> ModelConfig:
    # InternLM2-1.8B backbone: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
    # vocab=92553; InternViT frontend stub supplies patch embeddings.
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        pattern=("global",),
        activation="swiglu",
        frontend="vision",
        frontend_dim=1024,       # InternViT-300M width, projected to d_model
        n_frontend_tokens=256,   # pixel-unshuffled 448x448 tile
        rope_theta=1000000.0,
        source="[arXiv:2404.16821; hf]",
    )


@register
def hubert_xlarge() -> ModelConfig:
    # Encoder-only: 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 (k-means
    # targets); conv waveform frontend stub supplies frame embeddings.
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        pattern=("global",),
        activation="geglu",
        encoder_only=True,
        frontend="audio",
        frontend_dim=512,  # conv feature extractor output width
        emb_scale=False,
        source="[arXiv:2106.07447; unverified]",
    )


# ---------------------------------------------------------------------------
# Smoke variants — same family/pattern, laptop scale.
# ---------------------------------------------------------------------------


def _smoke(cfg: ModelConfig, **kw) -> ModelConfig:
    base = dict(
        n_layers=len(cfg.pattern) + len(cfg.pattern_tail),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=16,
        max_seq_len=4096,
        dtype="float32",
    )
    base.update(kw)
    return cfg.replace(**base)


@register_smoke("llama4-maverick-400b-a17b")
def smoke_llama4() -> ModelConfig:
    return _smoke(
        llama4_maverick(),
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128,
                      n_shared_experts=1, d_ff_shared=128),
    )


@register_smoke("deepseek-v2-236b")
def smoke_deepseek() -> ModelConfig:
    return _smoke(
        deepseek_v2(),
        n_layers=2,
        head_dim=24,  # nope16 + rope8
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared_experts=2, d_ff_shared=128,
                      first_dense_layers=1, d_ff_dense=128),
    )


@register_smoke("recurrentgemma-2b")
def smoke_recurrentgemma() -> ModelConfig:
    return _smoke(
        recurrentgemma_2b(),
        n_layers=5,  # one (rec, rec, local) period + (rec, rec) tail
        n_kv_heads=1,
        rglru=RGLRUConfig(lru_width=64, conv_width=4),
    )


@register_smoke("mamba2-2.7b")
def smoke_mamba2() -> ModelConfig:
    return _smoke(
        mamba2_2p7b(),
        n_heads=8,  # d_inner(128) / head_dim(16)
        n_kv_heads=0,
        ssd=SSDConfig(d_state=16, head_dim=16, expand=2, n_groups=1, chunk=8),
    )


@register_smoke("gemma-7b")
def smoke_gemma7b() -> ModelConfig:
    return _smoke(gemma_7b(), n_layers=2, n_kv_heads=4)


@register_smoke("qwen1.5-110b")
def smoke_qwen() -> ModelConfig:
    return _smoke(qwen15_110b(), n_layers=2)


@register_smoke("gemma3-12b")
def smoke_gemma3() -> ModelConfig:
    return _smoke(gemma3_12b())


@register_smoke("gemma2-2b")
def smoke_gemma2() -> ModelConfig:
    return _smoke(gemma2_2b())


@register_smoke("internvl2-2b")
def smoke_internvl() -> ModelConfig:
    return _smoke(internvl2_2b(), n_layers=2, frontend_dim=32,
                  n_frontend_tokens=8)


@register_smoke("hubert-xlarge")
def smoke_hubert() -> ModelConfig:
    return _smoke(hubert_xlarge(), n_layers=2, frontend_dim=32)
