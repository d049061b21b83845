"""Attention blocks: MHA / GQA / MQA, global / local / chunked (port of
``repro.models.attention``, without MLA).

Prefill and forward attention go through ``kernels.ops.attention_op``,
the hand-written flash kernel on the card, where the reference calls its
XLA q-block scan ``blockwise_attention``: both compute the same masked
softmax attention over one segment with query and key positions
``arange(S)``.  Decode (one new token against a cache) is direct
attention in plain PyTorch, as in the reference.

The decode cache is updated in place: the new token's k and v are written
into the cache tensors at its slot, and the same dict is returned, which
saves a copy of the whole cache per step.

Layout conventions:
    activations  (B, S, d_model)
    q/k/v        (B, S, H, D)
    caches       (B, L, H_kv, D)   (L = max_len for global, window for local)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops
from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_init, softcap

_NEG_INF = -2.3819763e38  # bf16-safe large negative


class AttnSpec(NamedTuple):
    """Static per-layer attention behaviour."""

    kind: str               # "global" | "local" | "chunked"
    causal: bool
    window: int             # receptive window for local/chunked
    rope_theta: float       # 0.0 -> NoPE (llama4 global layers)
    softcap: float
    qk_norm: bool


MLA_SLICE = ("MLA attention (deepseek-v2) is not ported yet: it arrives "
             "with a later slice of the LM model zoo (ROADMAP Queue A item 7)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool = False,
                   qk_norm: bool = False, dtype=torch.float32):
    dev = gen.device
    p = {
        "w_q": dense_init(gen, (d_model, n_heads, head_dim), d_model, dtype),
        "w_k": dense_init(gen, (d_model, n_kv_heads, head_dim), d_model,
                          dtype),
        "w_v": dense_init(gen, (d_model, n_kv_heads, head_dim), d_model,
                          dtype),
        "w_o": dense_init(gen, (n_heads, head_dim, d_model),
                          n_heads * head_dim, dtype),
    }
    if qkv_bias:
        p["b_q"] = torch.zeros((n_heads, head_dim), dtype=dtype, device=dev)
        p["b_k"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype,
                               device=dev)
        p["b_v"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype,
                               device=dev)
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, dev, dtype)
        p["k_norm"] = rmsnorm_init(head_dim, dev, dtype)
    return p


# ---------------------------------------------------------------------------
# Prefill / forward
# ---------------------------------------------------------------------------


def _qkv(params, x, spec: AttnSpec, positions, eps):
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["w_k"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["w_v"].to(dtype))
    if "b_q" in params:
        q = q + params["b_q"].to(dtype)
        k = k + params["b_k"].to(dtype)
        v = v + params["b_v"].to(dtype)
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q, eps)
        k = rmsnorm(params["k_norm"], k, eps)
    if spec.rope_theta:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _default_positions(x):
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


def _attend(q, k, v, spec: AttnSpec, use_kernel: bool):
    return ops.attention_op(q, k, v, causal=spec.causal, kind=spec.kind,
                            window=spec.window, softcap=spec.softcap,
                            use_kernel=use_kernel)


def attention_forward(params, x, spec: AttnSpec, positions=None,
                      eps: float = 1e-6, use_kernel: bool = True):
    """Full-sequence (train / prefill) attention.  x: (B, S, d_model)."""
    if positions is None:
        positions = _default_positions(x)
    q, k, v = _qkv(params, x, spec, positions, eps)
    out = _attend(q, k, v, spec, use_kernel)
    return torch.einsum("bshd,hdm->bsm", out, params["w_o"].to(x.dtype))


def attention_make_cache(params, x, spec: AttnSpec, cache_len: int,
                         positions=None, eps: float = 1e-6,
                         use_kernel: bool = True):
    """Prefill returning (output, cache) with the cache sized for decode."""
    B, S, _ = x.shape
    if positions is None:
        positions = _default_positions(x)
    q, k, v = _qkv(params, x, spec, positions, eps)
    out = _attend(q, k, v, spec, use_kernel)
    out = torch.einsum("bshd,hdm->bsm", out, params["w_o"].to(x.dtype))
    L = cache_len if spec.kind == "global" else min(spec.window, cache_len)
    if S >= L:
        # ring layout: position p lives at slot p % L
        ck, cv = k[:, S - L:], v[:, S - L:]
        if spec.kind != "global" and S % L:
            ck = torch.roll(ck, S % L, dims=1)
            cv = torch.roll(cv, S % L, dims=1)
        ck, cv = ck.contiguous(), cv.contiguous()
    else:
        pad = (0, 0, 0, 0, 0, L - S)
        ck = torch.nn.functional.pad(k, pad)
        cv = torch.nn.functional.pad(v, pad)
    return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Decode (one token per sequence, against a cache)
# ---------------------------------------------------------------------------


def attention_decode(params, x, cache, spec: AttnSpec, pos,
                     eps: float = 1e-6):
    """x: (B, 1, d_model); pos: (B,) int position of the new token.
    cache: {"k": (B, L, Hkv, D), "v": ...}, updated in place.
    Returns (out, cache)."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, spec, pos[:, None], eps)

    k, v = cache["k"], cache["v"]
    L = k.shape[1]
    if spec.kind == "global":
        slot = torch.clamp(pos, max=L - 1)
    else:
        slot = pos % L
    bidx = torch.arange(B, device=x.device)
    k[bidx, slot] = k_new[:, 0]
    v[bidx, slot] = v_new[:, 0]

    Hq, Dk = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, 1, Hkv, G, Dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if spec.softcap:
        s = softcap(s, spec.softcap)

    slots = torch.arange(L, device=x.device)[None]
    p_ = pos[:, None]
    if spec.kind == "global":
        valid = slots <= p_
    elif spec.kind == "local":
        valid = (slots <= p_) | (p_ + 1 >= L)
    else:  # chunked: visible slots are those written in the current chunk
        valid = slots <= (p_ % L)
    s = torch.where(valid[:, None, None, None], s, torch.full_like(s,
                                                                  _NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, 1, Hq, -1)
    out = torch.einsum("bshd,hdm->bsm", o, params["w_o"].to(x.dtype))
    return out, cache
