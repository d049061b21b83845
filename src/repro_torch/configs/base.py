"""Model/config system.

Every assigned architecture is described by a :class:`ModelConfig` — a frozen
dataclass that fully determines parameter shapes, the per-layer block pattern,
sharding-relevant dimensions and serving behaviour.  Configs are registered in
``REGISTRY`` and selectable by ``--arch <id>`` everywhere (launchers, dryrun,
benchmarks, tests).

Layer kinds
-----------
``global``     full (causal or bidirectional) attention
``local``      sliding-window attention (``window`` tokens)
``chunked``    chunked-local attention (llama4 iRoPE style: attention within
               aligned chunks of ``window`` tokens)
``recurrent``  RG-LRU block (RecurrentGemma / Griffin)
``ssm``        Mamba-2 SSD block

The per-layer pattern is expressed as a repeating ``pattern`` tuple plus an
optional ``pattern_tail`` for architectures whose depth is not a multiple of
the period (e.g. recurrentgemma-2b: 26 = 8x(rec,rec,local) + (rec,rec)).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0            # dimension of the shared expert MLP
    first_dense_layers: int = 0     # leading layers that use a dense MLP
    d_ff_dense: int = 0             # d_ff of dense (non-MoE) layers
    moe_period: int = 1             # MoE every `period` layers (llama4: 2)
    capacity_factor: float = 1.25
    router_softcap: float = 0.0
    dispatch: str = "sort"          # "sort" (scalable) | "einsum" (GShard)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSDConfig:
    """Mamba-2 SSD block dimensions."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block dimensions."""

    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4
    block_width_multiplier: float = 1.0


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    pattern: Tuple[str, ...] = ("global",)
    pattern_tail: Tuple[str, ...] = ()
    window: int = 4096              # local / chunked attention window
    activation: str = "swiglu"      # swiglu | geglu
    qkv_bias: bool = False
    qk_norm: bool = False
    post_norms: bool = False        # gemma2-style post-attn/post-ffn norms
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0  # gemma3: different theta for global layers
    nope_global: bool = False       # llama4 iRoPE: no rope on global layers
    tie_embeddings: bool = True
    encoder_only: bool = False
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_dim: int = 0           # embedding dim provided by the stub frontend
    n_frontend_tokens: int = 0      # number of prepended frontend tokens (vlm)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssd: Optional[SSDConfig] = None
    rglru: Optional[RGLRUConfig] = None
    emb_scale: bool = True          # gemma-style sqrt(d_model) embedding scale
    norm_eps: float = 1e-6
    max_seq_len: int = 1 << 20      # positional-encoding safety bound
    dtype: str = "bfloat16"
    # [source; verified-tier] provenance string from the assignment table
    source: str = ""

    # -- derived -----------------------------------------------------------
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list of length n_layers."""
        kinds: list[str] = []
        period = len(self.pattern)
        n_body = self.n_layers - len(self.pattern_tail)
        assert n_body % period == 0, (
            f"{self.name}: {n_body} body layers not a multiple of period "
            f"{period}; use pattern_tail"
        )
        for i in range(n_body):
            kinds.append(self.pattern[i % period])
        kinds.extend(self.pattern_tail)
        assert len(kinds) == self.n_layers
        return tuple(kinds)

    def n_periods(self) -> int:
        return (self.n_layers - len(self.pattern_tail)) // len(self.pattern)

    def is_subquadratic(self) -> bool:
        """True if no layer does unbounded full attention over the sequence,
        or the arch mixes bounded-window layers with a sparse set of global
        layers (gemma2/gemma3/llama4 style) — the assignment's criterion for
        running long_500k."""
        kinds = set(self.layer_kinds())
        if kinds <= {"ssm", "recurrent", "local", "chunked"}:
            return True
        # mixed local/global archs qualify (>=half the layers bounded)
        n_global = sum(1 for k in self.layer_kinds() if k == "global")
        return ("local" in kinds or "chunked" in kinds) and (
            n_global * 2 <= self.n_layers
        )

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim()
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings and not self.encoder_only:
            total += self.vocab_size * d
        if self.frontend is not None and self.frontend_dim:
            total += self.frontend_dim * d
        for i, kind in enumerate(self.layer_kinds()):
            total += 2 * d  # pre-norms (attn+ffn); close enough for post-norm
            if kind in ("global", "local", "chunked"):
                if self.mla is not None:
                    m = self.mla
                    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * m.q_lora_rank + m.q_lora_rank  # q down + norm
                    total += m.q_lora_rank * self.n_heads * qk_hd  # q up
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank  # kv norm
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim
                    )
                    total += self.n_heads * m.v_head_dim * d  # o proj
                else:
                    total += d * self.n_heads * hd  # q
                    total += 2 * d * self.n_kv_heads * hd  # k, v
                    total += self.n_heads * hd * d  # o
                    if self.qkv_bias:
                        total += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif kind == "recurrent":
                r = self.rglru or RGLRUConfig()
                w = r.lru_width or d
                nb = max(self.n_heads, 1)  # block-diagonal gate blocks
                total += 2 * d * w  # in-proj (x branch, gate branch)
                total += r.conv_width * w  # temporal conv
                total += 2 * w * (w // nb)  # block-diagonal r,i gates
                total += w  # a (recurrence decay) param
                total += w * d  # out proj
            elif kind == "ssm":
                s = self.ssd or SSDConfig()
                di = s.d_inner(d)
                nh = s.n_heads(d)
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                total += s.conv_width * (di + 2 * s.n_groups * s.d_state)
                total += 3 * nh  # A, D, dt_bias
                total += di  # gate norm
                total += di * d  # out proj
            # FFN
            if kind == "ssm":
                continue  # mamba2 blocks have no separate FFN
            if kind == "recurrent":
                total += 3 * d * self.d_ff
                continue
            if self.moe is not None and self.is_moe_layer(i):
                m = self.moe
                total += d * m.n_experts  # router
                total += m.n_experts * 3 * d * m.d_ff_expert
                if m.n_shared_experts:
                    total += 3 * d * (
                        m.d_ff_shared or m.d_ff_expert * m.n_shared_experts
                    )
            elif self.moe is not None:
                total += 3 * d * (m_dff := (self.moe.d_ff_dense or self.d_ff))
            else:
                total += 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_layer_all = m.n_experts * 3 * self.d_model * m.d_ff_expert
        per_layer_active = m.top_k * 3 * self.d_model * m.d_ff_expert
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if self.is_moe_layer(i)
        )
        return self.param_count() - n_moe_layers * (
            per_layer_all - per_layer_active
        )

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i`` uses the MoE FFN (vs a dense MLP)."""
        if self.moe is None:
            return False
        m = self.moe
        if i < m.first_dense_layers:
            return False
        return i % m.moe_period == m.moe_period - 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assignment: 4 per arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, "pure full-attention arch; long_500k needs sub-quadratic attention"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
SMOKE_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = fn()
    REGISTRY[cfg.name] = fn
    return fn


def register_smoke(name: str):
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        SMOKE_REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    if name not in SMOKE_REGISTRY:
        raise KeyError(f"no smoke config for {name!r}")
    return SMOKE_REGISTRY[name]()


def list_archs() -> list[str]:
    return sorted(REGISTRY)
