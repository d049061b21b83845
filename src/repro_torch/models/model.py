"""Model assembly: configs -> params -> forward / prefill / decode (port
of ``repro.models.model``).

The reference compiles depth as a ``lax.scan`` over periods of stacked
layer parameters; PyTorch runs eagerly, so here depth is a Python loop
over one parameter dict per layer, in layer order (head, then the
periods unrolled, then the tail).  ``models.convert.params_from_numpy``
unstacks the reference's tree into this layout.  A block's input takes
the "activations" hint (``pctx.constrain``: the identity on plain
tensors, a redistribution of the DTensors of a mesh step,
``distributed.steps``); inside a block the placements are those its
``pctx.local_block`` specs read from the same hints.

Param layout::

    {"embed": {"table"}, "lm_head"?: {"table"}, "frontend_proj"?,
     "final_norm": {"scale"}, "layers": [layer0, layer1, ...]}

A cache is a list of per-layer dicts with the batch on axis 0.  Decode
updates it in place and returns it.

Training goes through ``final_hidden`` (``models.steps.loss_fn``): with
``remat`` each period of the body runs under ``torch.utils.checkpoint``
(non-reentrant), the reference's ``jax.checkpoint`` of a period, so only
the periods' inputs are kept for the backward and each period's forward
runs again inside it.

Every layer kind of the reference is here: attention (global, local or
chunked, MHA / GQA / MQA, or MLA) and RG-LRU layers with a dense MLP or
an MoE FFN, Mamba-2 SSD blocks, the audio and vision frontends and
encoder-only (non-causal) attention.  MoE layers take a ``dispatch``
("einsum", "sort", "gshard:G", "sortg:G"; the config's when None) and
add their load-balance loss in "forward" mode, as the reference does.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..core.predictor import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import pctx
from . import rglru as rglru_mod
from . import ssd as ssd_mod
from .layers import (cast, dense_init, embed, embedding_init, mlp, mlp_init,
                     rmsnorm, rmsnorm_init, unembed)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               param_dtype):
    d = cfg.d_model
    dev = gen.device
    p: dict[str, Any] = {"pre_norm": rmsnorm_init(d, dev, param_dtype)}
    if spec.kind == "ssm":
        p["ssd"] = ssd_mod.ssd_init(gen, d, cfg.ssd, param_dtype)
        return p  # mamba2 block has no separate FFN / second norm
    if spec.kind == "recurrent":
        p["rglru"] = rglru_mod.rglru_init(gen, d, cfg.n_heads, cfg.rglru,
                                          param_dtype)
    else:
        if cfg.mla is not None:
            p["mla"] = attn.mla_init(gen, d, cfg.n_heads, cfg.mla,
                                     param_dtype)
        else:
            p["attn"] = attn.attention_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim(),
                cfg.qkv_bias, cfg.qk_norm, param_dtype)
        if cfg.post_norms:
            p["post_attn_norm"] = rmsnorm_init(d, dev, param_dtype)
    p["pre_ffn_norm"] = rmsnorm_init(d, dev, param_dtype)
    if spec.is_moe:
        p["moe"] = moe_mod.moe_init(gen, d, cfg.moe, param_dtype)
    elif spec.d_ff:
        p["mlp"] = mlp_init(gen, d, spec.d_ff, param_dtype)
    if cfg.post_norms:
        p["post_ffn_norm"] = rmsnorm_init(d, dev, param_dtype)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, param_dtype=torch.float32):
    """Random parameters on `device` (the card unless the caller names
    another), drawn from `generator` (a fresh one seeded 0 on that device
    when None).  Matmul weights and norm scales are `param_dtype`; the
    RG-LRU ``a_param``, the SSD's ``A_log``, ``D`` and ``dt_bias`` and
    the MoE router ``w_router`` stay f32."""
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
    if cfg.frontend is not None:
        params["frontend_proj"] = dense_init(
            generator, (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim,
            param_dtype)
    params["layers"] = [init_layer(generator, cfg, s, param_dtype)
                        for s in layer_specs(cfg)]
    return params


#: leaves the model reads in f32 whatever the compute dtype (norm scales,
#: the RG-LRU's a_param, the SSD's A_log and dt_bias, the MoE router)
F32_READ = ("scale", "a_param", "A_log", "dt_bias", "w_router")


def held_copies(cfg: ModelConfig, params) -> dict:
    """The bf16 working copies of `params`' f32 leaves that the forward
    casts to a bf16 compute dtype at use (``layers.cast``), each
    ``p.to(torch.bfloat16)``, keyed by the leaf's ``optim.adamw.keystr``:
    every f32 leaf but those read in f32 (F32_READ) and the input table
    where an ``lm_head`` is apart (only its gathered rows are cast, so
    that repeated tokens' gradients add in f32).  Empty at another
    compute dtype.  The one-card train step makes them (``distributed.steps
    .make_train_step``) and the AdamW update rewrites them."""
    from ..optim.adamw import keystr, leaves_with_path
    if compute_dtype(cfg) != torch.bfloat16:
        return {}
    out = {}
    for path, w in leaves_with_path(params):
        if (w.dtype != torch.float32 or pctx.is_dtensor(w)
                or path[-1].strip("[]'") in F32_READ
                or (path == ("['embed']", "['table']")
                    and "lm_head" in params)):
            continue
        out[keystr(path)] = w.detach().to(
            torch.bfloat16, memory_format=torch.contiguous_format)
    return out


def params_device(params) -> torch.device:
    return params["embed"]["table"].device


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device):
    if spec.kind == "ssm":
        s = cfg.ssd
        d = cfg.d_model
        conv_ch = s.d_inner(d) + 2 * s.n_groups * s.d_state
        return {"h": torch.zeros((batch, s.n_heads(d), s.head_dim,
                                  s.d_state), dtype=dtype, device=device),
                "conv": torch.zeros((batch, s.conv_width - 1, conv_ch),
                                    dtype=dtype, device=device)}
    if spec.kind == "recurrent":
        r = cfg.rglru
        w = r.lru_width or cfg.d_model
        return {"h": torch.zeros((batch, w), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, r.conv_width - 1, w),
                                    dtype=dtype, device=device)}
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                      dtype=dtype, device=device)}
    L = max_len if spec.kind == "global" else min(spec.window, max_len)
    shape = (batch, L, cfg.n_kv_heads, cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
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
                use_kernel: bool = True, dispatch: Optional[str] = None):
    """One block.  mode: "forward" | "prefill" | "decode".
    Returns (x, new_cache, aux): aux is an MoE layer's load-balance loss
    (f32) in "forward" mode, else 0.0."""
    eps = cfg.norm_eps
    aux = 0.0
    x = pctx.constrain(x, "activations")
    h = rmsnorm(params["pre_norm"], x, eps)
    new_cache = cache
    if spec.kind == "ssm":
        if mode == "forward":
            y = ssd_mod.ssd_forward(params["ssd"], h, cfg.ssd, eps,
                                    use_kernel=use_kernel)
        elif mode == "prefill":
            y, new_cache = ssd_mod.ssd_forward(
                params["ssd"], h, cfg.ssd, eps, return_state=True,
                use_kernel=use_kernel)
        else:
            y, new_cache = ssd_mod.ssd_decode(params["ssd"], h, cache,
                                              cfg.ssd, eps)
        return x + y, new_cache, aux  # no FFN half
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
        if cfg.mla is not None:
            if mode == "forward":
                y = attn.mla_forward(params["mla"], h, cfg.mla, aspec,
                                     positions, eps, use_kernel=use_kernel)
            elif mode == "prefill":
                y, new_cache = attn.mla_make_cache(
                    params["mla"], h, cfg.mla, aspec, cache_len, positions,
                    eps, use_kernel=use_kernel)
            else:
                y, new_cache = attn.mla_decode(params["mla"], h, cache,
                                               cfg.mla, aspec, pos, eps)
        elif mode == "forward":
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
    if spec.is_moe:
        y = moe_mod.moe_forward(params["moe"], h, cfg.moe, cfg.activation,
                                dispatch)
        if mode == "forward":
            aux = moe_mod.moe_aux_loss(params["moe"], h, cfg.moe)
    elif spec.d_ff:
        y = mlp(params["mlp"], h, cfg.activation)
    else:
        y = torch.zeros_like(x)
    x = x + _residual(cfg, params, "post_ffn_norm", y)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params, batch):
    """-> (x (B,S,d), positions (B,S)).  Audio: the projected frames
    (batch["frames"] (B, S, frontend_dim)); vision: the projected patch
    embeddings (batch["patch_embeds"]) followed by the embedded tokens."""
    dtype = compute_dtype(cfg)
    if cfg.frontend == "audio":
        x = batch["frames"].to(dtype) @ cast(params["frontend_proj"], dtype)
    elif cfg.frontend == "vision":
        img = (batch["patch_embeds"].to(dtype)
               @ cast(params["frontend_proj"], dtype))
        txt = embed(params["embed"], batch["tokens"], cfg.emb_scale,
                    cfg.d_model, dtype)
        x = torch.cat([img, txt], dim=1)
    else:
        x = embed(params["embed"], batch["tokens"], cfg.emb_scale,
                  cfg.d_model, dtype)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def apply_blocks(cfg: ModelConfig, params, x, positions, mode: str,
                 cache=None, pos=None, cache_len: int = 0,
                 use_kernel: bool = True, remat: bool = False,
                 dispatch: Optional[str] = None):
    """Run all layers in order.  Returns (x, new_cache, aux): new_cache
    is None in "forward" mode, aux the MoE layers' load-balance losses
    summed (0.0 without MoE layers or outside "forward" mode).
    `remat` ("forward" mode only) recomputes each period of the body in
    the backward instead of keeping its activations; the head and tail
    layers run as they are, as in the reference."""
    if remat:
        if mode != "forward":
            raise ValueError("remat applies to the forward (train) mode")
        x, aux = _apply_remat(cfg, params, x, positions, use_kernel,
                              dispatch)
        return x, None, aux
    new_cache = [] if mode != "forward" else None
    aux = 0.0
    for i, spec in enumerate(layer_specs(cfg)):
        c = cache[i] if cache is not None else None
        x, nc, a = block_apply(cfg, spec, params["layers"][i], x, positions,
                               mode, c, pos, cache_len, use_kernel, dispatch)
        aux = aux + a
        if new_cache is not None:
            new_cache.append(nc)
    return x, new_cache, aux


def _apply_remat(cfg: ModelConfig, params, x, positions, use_kernel: bool,
                 dispatch: Optional[str]):
    head, period, n_periods, tail = block_structure(cfg)
    specs = layer_specs(cfg)
    layers = params["layers"]

    def run(x, aux, lo, hi):
        for i in range(lo, hi):
            x, _, a = block_apply(cfg, specs[i], layers[i], x, positions,
                                  "forward", use_kernel=use_kernel,
                                  dispatch=dispatch)
            aux = aux + a
        return x, aux

    x, aux = run(x, 0.0, 0, len(head))
    for j in range(n_periods):
        lo = len(head) + j * len(period)
        # the blocks draw no random numbers (no dropout), so the RNG state
        # is not stashed for the recomputation: reading the CUDA
        # generator's state is refused while a graph is being captured
        x, aux = torch.utils.checkpoint.checkpoint(
            run, x, aux, lo, lo + len(period), use_reentrant=False,
            preserve_rng_state=False)
    return run(x, aux, len(specs) - len(tail), len(specs))


def final_hidden(cfg: ModelConfig, params, batch, use_kernel: bool = True,
                 remat: bool = False, dispatch: Optional[str] = None):
    """Full sequence -> (final hidden states, the MoE layers' summed
    load-balance loss); `remat` as in ``apply_blocks``."""
    x, positions = embed_inputs(cfg, params, batch)
    x, _, aux = apply_blocks(cfg, params, x, positions, "forward",
                             use_kernel=use_kernel, remat=remat,
                             dispatch=dispatch)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def logits_from_hidden(cfg: ModelConfig, params, h):
    return _capped(cfg, unembed(params.get("lm_head", params["embed"]), h))


def _capped(cfg: ModelConfig, out):
    if cfg.logit_softcap:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return out


@torch.no_grad()
def forward(cfg: ModelConfig, params, batch, use_kernel: bool = True,
            dispatch: Optional[str] = None):
    """batch: {"tokens": (B, S) int} (and "frames" or "patch_embeds" for
    a frontend) -> logits (B, S, V)."""
    h, _ = final_hidden(cfg, params, batch, use_kernel, dispatch=dispatch)
    return logits_from_hidden(cfg, params, h)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, cache_len: int,
            use_kernel: bool = True, dispatch: Optional[str] = None):
    """-> (last-position logits (B, V), cache sized for `cache_len`)."""
    x, positions = embed_inputs(cfg, params, batch)
    x, cache, _ = apply_blocks(cfg, params, x, positions, "prefill",
                               cache_len=cache_len, use_kernel=use_kernel,
                               dispatch=dispatch)
    h = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return logits_from_hidden(cfg, params, h)[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, tokens, pos, cache,
                dispatch: Optional[str] = None):
    """tokens: (B,) int; pos: (B,) int. -> (logits (B, V), cache); the
    cache is updated in place."""
    return decode_logits(cfg, params, tokens, pos, cache, dispatch)[0], cache


@torch.no_grad()
def decode_logits(cfg: ModelConfig, params, tokens, pos, cache,
                  dispatch: Optional[str] = None):
    """``decode_step``'s step -> (logits (B, V), the logits before the
    model's final softcap: the same tensor where it has none); the cache
    is updated in place.  The serving engine's step keeps both."""
    x = embed(params["embed"], tokens[:, None], cfg.emb_scale, cfg.d_model,
              compute_dtype(cfg))
    x, cache, _ = apply_blocks(cfg, params, x, pos[:, None], "decode",
                               cache=cache, pos=pos, dispatch=dispatch)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    pre = unembed(params.get("lm_head", params["embed"]), h)[:, 0]
    return _capped(cfg, pre), pre
