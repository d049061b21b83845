"""Attention blocks: MHA / GQA / MQA, global / local / chunked, and MLA
(port of ``repro.models.attention``).

Prefill and forward attention go through ``kernels.ops.attention_op``,
the hand-written flash kernel on the card, where the reference calls its
XLA q-block scan ``blockwise_attention``: both compute the same masked
softmax attention over one segment with query and key positions
``arange(S)``.  Decode (one new token against a cache) is direct
attention in plain PyTorch, as in the reference.  MLA (DeepSeek-V2's
multi-head latent attention) prefills through the same kernel with query
and key head dim ``qk_nope + qk_rope`` (192 at full width) and value head
dim ``v_head_dim`` (128), scaled by 1/sqrt of the former as the
reference's ``blockwise_attention`` is; its decode is the absorbed-q
decode over the compressed (B, L, kv_lora_rank) latent cache, plain
PyTorch einsums as in the reference.

The decode cache is updated in place: the new token's k and v are written
into the cache tensors at its slot, and the same dict is returned, which
saves a copy of the whole cache per step.  A mesh step's decode runs on
each rank's shards (``_decode_shards``) and returns its cache in a new
dict of DTensors.

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
from . import pctx
from .layers import (apply_rope, cast, dense_init, rmsnorm, rmsnorm_init,
                     softcap, write_state)

_NEG_INF = -2.3819763e38  # bf16-safe large negative


class AttnSpec(NamedTuple):
    """Static per-layer attention behaviour."""

    kind: str               # "global" | "local" | "chunked"
    causal: bool
    window: int             # receptive window for local/chunked
    rope_theta: float       # 0.0 -> NoPE (llama4 global layers)
    softcap: float
    qk_norm: bool


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


def mla_init(gen: torch.Generator, d_model: int, n_heads: int, mla,
             dtype=torch.float32):
    dev = gen.device
    qk_hd = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, (d_model, mla.q_lora_rank), d_model, dtype),
        "q_norm": rmsnorm_init(mla.q_lora_rank, dev, dtype),
        "w_uq": dense_init(gen, (mla.q_lora_rank, n_heads, qk_hd),
                           mla.q_lora_rank, dtype),
        "w_dkv": dense_init(
            gen, (d_model, mla.kv_lora_rank + mla.qk_rope_head_dim),
            d_model, dtype),
        "kv_norm": rmsnorm_init(mla.kv_lora_rank, dev, dtype),
        "w_ukv": dense_init(
            gen, (mla.kv_lora_rank, n_heads,
                  mla.qk_nope_head_dim + mla.v_head_dim),
            mla.kv_lora_rank, dtype),
        "w_o": dense_init(gen, (n_heads, mla.v_head_dim, d_model),
                          n_heads * mla.v_head_dim, dtype),
    }


# ---------------------------------------------------------------------------
# Prefill / forward
# ---------------------------------------------------------------------------


def _qkv(params, x, spec: AttnSpec, positions, eps):
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, cast(params["w_q"], dtype))
    k = torch.einsum("bsd,dhk->bshk", x, cast(params["w_k"], dtype))
    v = torch.einsum("bsd,dhk->bshk", x, cast(params["w_v"], dtype))
    if "b_q" in params:
        q = q + cast(params["b_q"], dtype)
        k = k + cast(params["b_k"], dtype)
        v = v + cast(params["b_v"], dtype)
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
    """Full-sequence (train / prefill) attention.  x: (B, S, d_model).
    On DTensors the whole block runs on each rank's shards
    (``_attention_shards``)."""
    if positions is None:
        positions = _default_positions(x)
    if pctx.is_dtensor(x):
        return _attention_shards(params, x, spec, positions, eps,
                                 use_kernel)
    q, k, v = _qkv(params, x, spec, positions, eps)
    out = _attend(q, k, v, spec, use_kernel)
    return torch.einsum("bshd,hdm->bsm", out, cast(params["w_o"], x.dtype))


def _heads_axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _tp(params, x):
    """(query heads' entry, kv heads' entry, parameter specs, kv picker)
    of attention on each rank's shards (Megatron's tensor-parallel
    attention): the query heads as the "attn_q" hint splits them, the kv
    heads as "attn_kv" does; where the kv heads stay whole and the query
    heads are split, the picker takes (dimension 2 of k and v) the kv
    heads the rank's query heads read."""
    hq = pctx.spec_of("attn_q", 4)[2]
    hkv = pctx.spec_of("attn_kv", 4)[2]
    Hq, Hkv = params["w_q"].shape[1], params["w_k"].shape[1]
    pick = None
    if hq is not None and hkv is None and Hkv != Hq:
        pick = pctx.heads_picker(x.device_mesh, hq, Hq, Hkv, x.device)

    def pspec(path, t):
        name = path.split("/")[0]
        return {"w_q": (None, hq, None), "w_k": (None, hkv, None),
                "w_v": (None, hkv, None), "w_o": (hq, None, None),
                "b_q": (hq, None), "b_k": (hkv, None),
                "b_v": (hkv, None)}.get(name, (None,) * t.ndim)
    return hq, hkv, pspec, pick


def _attn_local(p, x, positions, spec: AttnSpec, eps, use_kernel: bool,
                pick, cache_len=None):
    """The block on one rank's local tensors: its kv heads all projected
    (a cache keeps them), those its query heads read attended."""
    q, k, v = _qkv(p, x, spec, positions, eps)
    kr, vr = (pick(k), pick(v)) if pick is not None else (k, v)
    o = _attend(q, kr, vr, spec, use_kernel)
    out = torch.einsum("bshd,hdm->bsm", o, cast(p["w_o"], x.dtype))
    if cache_len is None:
        return out
    return (out,) + _prefill_cache(k, v, spec, cache_len)


def _attention_shards(params, x, spec: AttnSpec, positions, eps,
                      use_kernel: bool, cache_len=None):
    """``attention_forward`` (or, with `cache_len`, ``attention_make_
    cache``) on each rank's shards (``pctx.local_block``, split as
    ``_tp`` splits it): the output projection's partial sums added over
    the heads' axis; a cache of the kv heads as "attn_kv" places them."""
    hq, hkv, pspec, pick = _tp(params, x)
    rows = pctx.activation_rows(3)
    block = lambda p, x, pos: _attn_local(p, x, pos, spec, eps, use_kernel,
                                          pick, cache_len)
    if cache_len is None:
        return pctx.local_block(block, params, x, pspec, rows,
                                partial=_heads_axes(hq), extra=(positions,),
                                extra_specs=(rows[:2],))
    kv = (rows[0], None, hkv, None)
    out, ck, cv = pctx.local_block(
        block, params, x, pspec, [rows, kv, kv],
        partial=[_heads_axes(hq), (), ()], extra=(positions,),
        extra_specs=(rows[:2],))
    return out, {"k": ck, "v": cv}


def attention_make_cache(params, x, spec: AttnSpec, cache_len: int,
                         positions=None, eps: float = 1e-6,
                         use_kernel: bool = True):
    """Prefill returning (output, cache) with the cache sized for decode.
    On DTensors the block runs on each rank's shards
    (``_attention_shards``)."""
    if positions is None:
        positions = _default_positions(x)
    if pctx.is_dtensor(x):
        return _attention_shards(params, x, spec, positions, eps,
                                 use_kernel, cache_len)
    q, k, v = _qkv(params, x, spec, positions, eps)
    out = _attend(q, k, v, spec, use_kernel)
    out = torch.einsum("bshd,hdm->bsm", out, cast(params["w_o"], x.dtype))
    ck, cv = _prefill_cache(k, v, spec, cache_len)
    return out, {"k": ck, "v": cv}


def _prefill_cache(k, v, spec: AttnSpec, cache_len: int):
    """The decode cache (k, v) of a prefill's k, v (B, S, Hkv, D)."""
    S = k.shape[1]
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
    return ck, cv


# ---------------------------------------------------------------------------
# Decode (one token per sequence, against a cache)
# ---------------------------------------------------------------------------


def attention_decode(params, x, cache, spec: AttnSpec, pos,
                     eps: float = 1e-6):
    """x: (B, 1, d_model); pos: (B,) int position of the new token.
    cache: {"k": (B, L, Hkv, D), "v": ...}, updated in place.
    Returns (out, cache)."""
    if pctx.is_dtensor(x):
        return _decode_shards(params, x, cache, spec, pos, eps)
    q, k_new, v_new = _qkv(params, x, spec, pos[:, None], eps)
    k, v = _write_kv(cache, spec, pos, k_new, v_new)
    return _decode_attend(params, x, q, k, v, spec, pos), cache


def _write_kv(cache, spec: AttnSpec, pos, k_new, v_new):
    L = cache["k"].shape[1]
    slot = torch.clamp(pos, max=L - 1) if spec.kind == "global" \
        else pos % L
    return (write_state(cache, "k", k_new, slot),
            write_state(cache, "v", v_new, slot))


def _decode_shards(params, x, cache, spec: AttnSpec, pos, eps):
    """``attention_decode`` on each rank's shards (``pctx.local_block``,
    split as ``_tp`` splits it): the cache's kv heads as the "attn_kv"
    hint places them, all of them written where they stay whole, those
    the rank's query heads read attended; its length whole on each rank
    (a cache split over its length, sequence parallelism, is gathered)."""
    hq, hkv, pspec, pick = _tp(params, x)

    def block(p, x, k, v, pos):
        q, k_new, v_new = _qkv(p, x, spec, pos[:, None], eps)
        k, v = _write_kv({"k": k, "v": v}, spec, pos, k_new, v_new)
        kr, vr = (pick(k), pick(v)) if pick is not None else (k, v)
        return _decode_attend(p, x, q, kr, vr, spec, pos), k, v
    rows = pctx.activation_rows(3)
    kv = (rows[0], None, hkv, None)
    out, k, v = pctx.local_block(
        block, params, x, pspec, [rows, kv, kv],
        partial=[_heads_axes(hq), (), ()], extra=(cache["k"], cache["v"],
                                                 pos),
        extra_specs=(kv, kv, rows[:1]))
    return out, {"k": k, "v": v}


def _decode_attend(params, x, q, k, v, spec: AttnSpec, pos):
    """The new token's attention over the written cache k, v and its
    output projection."""
    B = x.shape[0]
    L = k.shape[1]
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
    return torch.einsum("bshd,hdm->bsm", o, cast(params["w_o"], x.dtype))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_q(params, x, mla, spec: AttnSpec, positions, eps):
    dtype = x.dtype
    c_q = x @ cast(params["w_dq"], dtype)
    c_q = rmsnorm(params["q_norm"], c_q, eps)
    q = torch.einsum("bsl,lhk->bshk", c_q, cast(params["w_uq"], dtype))
    q_nope = q[..., : mla.qk_nope_head_dim]
    q_rope = apply_rope(q[..., mla.qk_nope_head_dim:], positions,
                        spec.rope_theta)
    return q_nope, q_rope


def _mla_ckv(params, x, mla, spec: AttnSpec, positions, eps):
    dtype = x.dtype
    dkv = x @ cast(params["w_dkv"], dtype)
    c_kv = rmsnorm(params["kv_norm"], dkv[..., : mla.kv_lora_rank], eps)
    k_rope = apply_rope(dkv[..., mla.kv_lora_rank:][:, :, None, :],
                        positions, spec.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_attend(params, x, mla, spec: AttnSpec, positions, eps,
                use_kernel: bool):
    """Up-project q, k and v, attend, project out.  Returns (out, c_kv,
    k_rope), the latent and the rotated key part a cache keeps."""
    B, S, _ = x.shape
    dtype = x.dtype
    q_nope, q_rope = _mla_q(params, x, mla, spec, positions, eps)
    c_kv, k_rope = _mla_ckv(params, x, mla, spec, positions, eps)
    kv = torch.einsum("bsl,lhk->bshk", c_kv, cast(params["w_ukv"], dtype))
    k_nope = kv[..., : mla.qk_nope_head_dim]
    v = kv[..., mla.qk_nope_head_dim:]
    H = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, mla.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = _attend(q, k, v, spec, use_kernel)
    out = torch.einsum("bshd,hdm->bsm", out, cast(params["w_o"], dtype))
    return out, c_kv, k_rope


def mla_forward(params, x, mla, spec: AttnSpec, positions=None,
                eps: float = 1e-6, use_kernel: bool = True):
    """Prefill/train MLA: up-project, then attention with q and k of head
    dim qk_nope + qk_rope and v of head dim v_head_dim.  On DTensors the
    whole block runs on each rank's shards (``pctx.local_block``): its
    batch rows and the heads as the "attn_q" hint splits them (the
    low-rank projections gathered), the output's partial sums added over
    the heads' axis."""
    if positions is None:
        positions = _default_positions(x)
    if pctx.is_dtensor(x):
        hq = pctx.spec_of("attn_q", 4)[2]
        rows = pctx.activation_rows(3)
        return pctx.local_block(
            lambda p, x, pos: mla_forward(p, x, mla, spec, pos, eps,
                                          use_kernel),
            params, x, _mla_pspec(hq), rows, partial=_heads_axes(hq),
            extra=(positions,), extra_specs=(rows[:2],))
    return _mla_attend(params, x, mla, spec, positions, eps, use_kernel)[0]


def _mla_pspec(hq):
    """MLA's parameter specs on each rank's shards: the heads as the
    "attn_q" hint splits them, the low-rank projections gathered."""
    def pspec(path, t):
        name = path.split("/")[0]
        return {"w_uq": (None, hq, None), "w_ukv": (None, hq, None),
                "w_o": (hq, None, None)}.get(name, (None,) * t.ndim)
    return pspec


def mla_make_cache(params, x, mla, spec: AttnSpec, cache_len: int,
                   positions=None, eps: float = 1e-6,
                   use_kernel: bool = True):
    """Prefill returning (output, cache): the cache holds the latent
    c_kv (B, L, kv_lora_rank) and the rotated k_rope (B, L, qk_rope), the
    reference's layout, sized for decode.  On DTensors the block runs on
    each rank's shards, as ``mla_forward``'s, the latent cache whole on
    every rank of the heads' axis."""
    S = x.shape[1]
    if positions is None:
        positions = _default_positions(x)
    if pctx.is_dtensor(x):
        hq = pctx.spec_of("attn_q", 4)[2]
        rows = pctx.activation_rows(3)

        def block(p, x, pos):
            out, c = mla_make_cache(p, x, mla, spec, cache_len, pos, eps,
                                    use_kernel)
            return out, c["c_kv"], c["k_rope"]
        out, c_kv, k_rope = pctx.local_block(
            block, params, x, _mla_pspec(hq), [rows, rows, rows],
            partial=[_heads_axes(hq), (), ()], extra=(positions,),
            extra_specs=(rows[:2],))
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    out, c_kv, k_rope = _mla_attend(params, x, mla, spec, positions, eps,
                                    use_kernel)
    L = cache_len
    if S >= L:
        c_kv = c_kv[:, S - L:].contiguous()
        k_rope = k_rope[:, S - L:].contiguous()
    else:
        c_kv = torch.nn.functional.pad(c_kv, (0, 0, 0, L - S))
        k_rope = torch.nn.functional.pad(k_rope, (0, 0, 0, L - S))
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(params, x, cache, mla, spec: AttnSpec, pos,
               eps: float = 1e-6):
    """Absorbed-q MLA decode: scores and context are computed in the
    latent space, so the cache stays (B, L, kv_lora_rank) and is never
    re-expanded per step.  The cache is updated in place.  On DTensors
    the step runs on each rank's shards (``pctx.local_block``): its batch
    rows and heads, the latent cache whole on every rank of the heads'
    axis."""
    if pctx.is_dtensor(x):
        hq = pctx.spec_of("attn_q", 4)[2]
        pspec = _mla_pspec(hq)

        def block(p, x, c_kv, k_rope, pos):
            out, c = mla_decode(p, x, {"c_kv": c_kv, "k_rope": k_rope},
                                mla, spec, pos, eps)
            return out, c["c_kv"], c["k_rope"]
        rows = pctx.activation_rows(3)
        out, c_kv, k_rope = pctx.local_block(
            block, params, x, pspec, [rows, rows, rows],
            partial=[_heads_axes(hq), (), ()],
            extra=(cache["c_kv"], cache["k_rope"], pos),
            extra_specs=(rows, rows, rows[:1]))
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    B = x.shape[0]
    dtype = x.dtype
    q_nope, q_rope = _mla_q(params, x, mla, spec, pos[:, None], eps)
    ckv_new, krope_new = _mla_ckv(params, x, mla, spec, pos[:, None], eps)

    L = cache["c_kv"].shape[1]
    slot = torch.clamp(pos, max=L - 1)
    c_kv = write_state(cache, "c_kv", ckv_new, slot)
    k_rope = write_state(cache, "k_rope", krope_new, slot)

    w_ukv = cast(params["w_ukv"], dtype)
    w_uk = w_ukv[..., : mla.qk_nope_head_dim]        # (lora, H, nope)
    w_uv = w_ukv[..., mla.qk_nope_head_dim:]          # (lora, H, v)
    q_abs = torch.einsum("bthn,lhn->bthl", q_nope, w_uk)  # (B, 1, H, lora)

    scale = 1.0 / math.sqrt(mla.qk_nope_head_dim + mla.qk_rope_head_dim)
    s = (torch.einsum("bthl,bsl->bhts", q_abs.float(), c_kv.float())
         + torch.einsum("bthr,bsr->bhts", q_rope.float(),
                        k_rope.float())) * scale
    valid = torch.arange(L, device=x.device)[None] <= pos[:, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(dtype)
    ctx = torch.einsum("bhts,bsl->bthl", p, c_kv)
    o = torch.einsum("bthl,lhv->bthv", ctx, w_uv)
    out = torch.einsum("bshd,hdm->bsm", o, cast(params["w_o"], dtype))
    return out, cache
