"""Model assembly: configs -> params -> forward / prefill / decode (port
of ``repro.models.model``).

The reference compiles depth as a ``lax.scan`` over periods of stacked
layer parameters; PyTorch runs eagerly, so here depth is a Python loop
over one parameter dict per layer, in layer order (head, then the
periods unrolled, then the tail).  ``models.convert.params_from_numpy``
unstacks the reference's tree into this layout.  The reference's ``pctx``
sharding hints mean nothing on one card, so the ``constrain`` calls are
dropped.

Param layout::

    {"embed": {"table"}, "lm_head"?: {"table"}, "final_norm": {"scale"},
     "layers": [layer0, layer1, ...]}

A cache is a list of per-layer dicts with the batch on axis 0.  Decode
updates it in place and returns it.

This slice brings the dense-MLP attention and RG-LRU layers
(recurrentgemma); SSM, MoE and MLA layers and the audio / vision
frontends raise ``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..core.predictor import resolve_device
from . import attention as attn
from . import rglru as rglru_mod
from .layers import (embed, embedding_init, mlp, mlp_init, rmsnorm,
                     rmsnorm_init, unembed)

SSM_SLICE = ("SSM (Mamba-2 SSD) layers are not ported yet: they arrive "
             "with the mamba2-2.7b serving slice and its ssd_scan kernel")
MOE_SLICE = ("MoE layers are not ported yet: they arrive with a later "
             "slice of the LM model zoo (ROADMAP Queue A item 7)")
FRONTEND_SLICE = ("audio / vision frontends are not ported yet: they "
                  "arrive with a later slice of the LM model zoo")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class LayerSpec(NamedTuple):
    kind: str            # global | local | chunked | recurrent | ssm
    is_moe: bool
    d_ff: int            # dense-FFN width for this layer (0 -> no FFN)
    rope_theta: float    # 0.0 -> NoPE
    window: int
    causal: bool


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    specs = []
    for i, kind in enumerate(cfg.layer_kinds()):
        is_moe = cfg.is_moe_layer(i)
        if kind == "ssm":
            d_ff = 0
        elif is_moe:
            d_ff = 0  # MoE layer: expert dims live in MoEConfig
        elif cfg.moe is not None:
            d_ff = cfg.moe.d_ff_dense or cfg.d_ff
        else:
            d_ff = cfg.d_ff
        if kind == "global":
            theta = (0.0 if cfg.nope_global
                     else (cfg.rope_theta_global or cfg.rope_theta))
        else:
            theta = cfg.rope_theta
        specs.append(LayerSpec(
            kind=kind, is_moe=is_moe, d_ff=d_ff, rope_theta=theta,
            window=cfg.window, causal=not cfg.encoder_only))
    return specs


def block_structure(cfg: ModelConfig):
    """-> (head_specs, period_specs, n_periods, tail_specs), the
    reference's split of the layers; ``layer_specs`` is their
    concatenation with the period repeated ``n_periods`` times."""
    specs = layer_specs(cfg)
    n_head = cfg.moe.first_dense_layers if cfg.moe else 0
    n_tail = len(cfg.pattern_tail)
    body = specs[n_head: len(specs) - n_tail] if n_tail else specs[n_head:]
    P = len(cfg.pattern)
    if cfg.moe is not None:
        P = math.lcm(P, cfg.moe.moe_period)
    if len(body) % P:
        raise ValueError(f"{cfg.name}: {len(body)} body layers are not a "
                         f"multiple of the period {P}")
    n_periods = len(body) // P
    period = body[:P]
    for j in range(n_periods):
        if tuple(body[j * P: (j + 1) * P]) != tuple(period):
            raise ValueError(f"{cfg.name}: periods are not uniform")
    tail = specs[len(specs) - n_tail:] if n_tail else []
    return specs[:n_head], period, n_periods, tail


def attn_spec(cfg: ModelConfig, spec: LayerSpec):
    return attn.AttnSpec(
        kind=spec.kind, causal=spec.causal, window=spec.window,
        rope_theta=spec.rope_theta, softcap=cfg.attn_softcap,
        qk_norm=cfg.qk_norm)


def check_supported(cfg: ModelConfig):
    """Raise for the parts of a config this slice does not port.  Every
    entry point calls it, so below it a layer is attention (global,
    local or chunked, not MLA) or recurrent, with a dense MLP."""
    if cfg.frontend is not None:
        raise NotImplementedError(FRONTEND_SLICE)
    if cfg.moe is not None:
        raise NotImplementedError(MOE_SLICE)
    kinds = set(cfg.layer_kinds())
    if "ssm" in kinds:
        raise NotImplementedError(SSM_SLICE)
    if cfg.mla is not None and kinds & {"global", "local", "chunked"}:
        raise NotImplementedError(attn.MLA_SLICE)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               param_dtype):
    d = cfg.d_model
    dev = gen.device
    p: dict[str, Any] = {"pre_norm": rmsnorm_init(d, dev, param_dtype)}
    if spec.kind == "recurrent":
        p["rglru"] = rglru_mod.rglru_init(gen, d, cfg.n_heads, cfg.rglru,
                                          param_dtype)
    else:
        p["attn"] = attn.attention_init(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim(),
            cfg.qkv_bias, cfg.qk_norm, param_dtype)
        if cfg.post_norms:
            p["post_attn_norm"] = rmsnorm_init(d, dev, param_dtype)
    p["pre_ffn_norm"] = rmsnorm_init(d, dev, param_dtype)
    p["mlp"] = mlp_init(gen, d, spec.d_ff, param_dtype)
    if cfg.post_norms:
        p["post_ffn_norm"] = rmsnorm_init(d, dev, param_dtype)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, param_dtype=torch.float32):
    """Random parameters on `device` (the card unless the caller names
    another), drawn from `generator` (a fresh one seeded 0 on that device
    when None).  Matmul weights and norm scales are `param_dtype`; the
    RG-LRU ``a_param`` stays f32."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}")
    params: dict[str, Any] = {
        "embed": embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                param_dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dev, param_dtype),
    }
    if not cfg.tie_embeddings and not cfg.encoder_only:
        params["lm_head"] = embedding_init(generator, cfg.vocab_size,
                                           cfg.d_model, param_dtype)
    params["layers"] = [init_layer(generator, cfg, s, param_dtype)
                        for s in layer_specs(cfg)]
    return params


def params_device(params) -> torch.device:
    return params["embed"]["table"].device


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device):
    if spec.kind == "recurrent":
        r = cfg.rglru
        w = r.lru_width or cfg.d_model
        return {"h": torch.zeros((batch, w), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, r.conv_width - 1, w),
                                    dtype=dtype, device=device)}
    L = max_len if spec.kind == "global" else min(spec.window, max_len)
    shape = (batch, L, cfg.n_kv_heads, cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = compute_dtype(cfg)
    return [init_layer_cache(cfg, s, batch, max_len, dtype, dev)
            for s in layer_specs(cfg)]


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def _residual(cfg, params, key, y):
    if cfg.post_norms and key in params:
        y = rmsnorm(params[key], y, cfg.norm_eps)
    return y


def block_apply(cfg: ModelConfig, spec: LayerSpec, params, x, positions,
                mode: str, cache=None, pos=None, cache_len: int = 0,
                use_kernel: bool = True):
    """One block.  mode: "forward" | "prefill" | "decode".
    Returns (x, new_cache)."""
    eps = cfg.norm_eps
    h = rmsnorm(params["pre_norm"], x, eps)
    new_cache = cache
    if spec.kind == "recurrent":
        if mode == "forward":
            y = rglru_mod.rglru_forward(params["rglru"], h, cfg.n_heads,
                                        cfg.rglru, use_kernel=use_kernel)
        elif mode == "prefill":
            y, new_cache = rglru_mod.rglru_forward(
                params["rglru"], h, cfg.n_heads, cfg.rglru,
                return_state=True, use_kernel=use_kernel)
        else:
            y, new_cache = rglru_mod.rglru_decode(params["rglru"], h, cache,
                                                  cfg.n_heads, cfg.rglru)
        x = x + y
    else:
        aspec = attn_spec(cfg, spec)
        if mode == "forward":
            y = attn.attention_forward(params["attn"], h, aspec, positions,
                                       eps, use_kernel=use_kernel)
        elif mode == "prefill":
            y, new_cache = attn.attention_make_cache(
                params["attn"], h, aspec, cache_len, positions, eps,
                use_kernel=use_kernel)
        else:
            y, new_cache = attn.attention_decode(params["attn"], h, cache,
                                                 aspec, pos, eps)
        x = x + _residual(cfg, params, "post_attn_norm", y)

    h = rmsnorm(params["pre_ffn_norm"], x, eps)
    y = mlp(params["mlp"], h, cfg.activation)
    x = x + _residual(cfg, params, "post_ffn_norm", y)
    return x, new_cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params, batch):
    """-> (x (B,S,d), positions (B,S))."""
    x = embed(params["embed"], batch["tokens"], cfg.emb_scale, cfg.d_model,
              compute_dtype(cfg))
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def apply_blocks(cfg: ModelConfig, params, x, positions, mode: str,
                 cache=None, pos=None, cache_len: int = 0,
                 use_kernel: bool = True):
    """Run all layers in order.  Returns (x, new_cache); new_cache is
    None in "forward" mode."""
    new_cache = [] if mode != "forward" else None
    for i, spec in enumerate(layer_specs(cfg)):
        c = cache[i] if cache is not None else None
        x, nc = block_apply(cfg, spec, params["layers"][i], x, positions,
                            mode, c, pos, cache_len, use_kernel)
        if new_cache is not None:
            new_cache.append(nc)
    return x, new_cache


def final_hidden(cfg: ModelConfig, params, batch, use_kernel: bool = True):
    """Full sequence -> final hidden states."""
    x, positions = embed_inputs(cfg, params, batch)
    x, _ = apply_blocks(cfg, params, x, positions, "forward",
                        use_kernel=use_kernel)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def logits_from_hidden(cfg: ModelConfig, params, h):
    table = params.get("lm_head", params["embed"])
    out = unembed(table, h)
    if cfg.logit_softcap:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return out


@torch.no_grad()
def forward(cfg: ModelConfig, params, batch, use_kernel: bool = True):
    """batch: {"tokens": (B, S) int} -> logits (B, S, V)."""
    check_supported(cfg)
    h = final_hidden(cfg, params, batch, use_kernel)
    return logits_from_hidden(cfg, params, h)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, cache_len: int,
            use_kernel: bool = True):
    """-> (last-position logits (B, V), cache sized for `cache_len`)."""
    check_supported(cfg)
    x, positions = embed_inputs(cfg, params, batch)
    x, cache = apply_blocks(cfg, params, x, positions, "prefill",
                            cache_len=cache_len, use_kernel=use_kernel)
    h = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return logits_from_hidden(cfg, params, h)[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, tokens, pos, cache):
    """tokens: (B,) int; pos: (B,) int. -> (logits (B, V), cache); the
    cache is updated in place."""
    check_supported(cfg)
    x = embed(params["embed"], tokens[:, None], cfg.emb_scale, cfg.d_model,
              compute_dtype(cfg))
    x, cache = apply_blocks(cfg, params, x, pos[:, None], "decode",
                            cache=cache, pos=pos)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(cfg, params, h)[:, 0], cache
