"""Shared neural-net building blocks (port of ``repro.models.layers``).

Plain functions over explicit parameter dicts of tensors.  Compute dtype
and parameter dtype are decoupled: parameters may be f32 or bf16 and are
cast at use to the activations' dtype (``cfg.dtype``), every such use
through ``cast``, which the one-card train step answers from its held
bf16 working copies (``held_casts``).  Initialisers
draw from an explicit ``torch.Generator`` on the parameters' device; they
cannot reproduce ``jax.random``, so parity with the reference is held by
converting its parameters (``models.convert``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import pctx

# ---------------------------------------------------------------------------
# Casts at use, and the train step's held working copies
# ---------------------------------------------------------------------------

#: inside ``held_casts``: id(leaf) -> (leaf, its working copy)
_HELD: Optional[dict] = None


class HeldCast(torch.autograd.Function):
    """``w.to(held.dtype)`` answered by `held`, a working copy of `w` that
    its writer keeps bitwise equal to that cast: the forward launches
    nothing and returns an alias of `held`; the backward is
    ``ToCopyBackward``'s, the gradient cast back to `w`'s dtype.  One node
    a use, as ``.to()`` makes, so autograd sums a leaf's uses in f32 in
    the same order."""

    @staticmethod
    def forward(ctx, w, held):
        ctx.dtype = w.dtype
        # a new tensor over held's storage: an output that is an input
        # would come back as a view of it
        return held.detach()

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


@contextmanager
def held_casts(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]):
    """Inside, ``cast`` answers each leaf of `pairs` ((leaf, working
    copy)) by its copy.  Read from any thread (the backward's recomputed
    forwards run on autograd's); not re-entrant across threads."""
    global _HELD
    before = _HELD
    _HELD = {id(w): (w, h) for w, h in pairs}
    try:
        yield
    finally:
        _HELD = before


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Parameter `w` in the compute dtype, the one cast every use of a
    parameter goes through: ``w.to(dtype)``, or inside ``held_casts`` the
    working copy of `w` (``HeldCast``).  There an f32 leaf cast without a
    copy of `dtype` counts one in ``cast.misses``."""
    if _HELD is None or w.dtype == dtype:
        return w.to(dtype)
    hit = _HELD.get(id(w))
    if hit is None or hit[0] is not w or hit[1].dtype != dtype:
        cast.misses += 1
        return w.to(dtype)
    return HeldCast.apply(w, hit[1])


cast.misses = 0

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / _SQRT2))


#: the largest f32 draw ``dense_init`` makes in one piece (bytes); a
#: larger tensor is drawn one slice of its first axis at a time, so that
#: its f32 draw never sits beside the weights already made.
#: llama4-maverick's stacked experts (128 x 5,120 x 8,192: 21.5 GB in
#: f32, 10.7 GB in bf16) would not fit beside the 60 GB of bf16 weights
#: before them on one 80 GB card; every other tensor of the ten
#: architectures is drawn whole (deepseek-v2's experts, 5.0 GB, the
#: largest of them)
WHOLE_DRAW_BYTES = 8 << 30


def _truncated_normal(gen: torch.Generator, shape, std: float):
    lo, hi = _normal_cdf(-2.0), _normal_cdf(2.0)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    t.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
    return t.mul_(std)


def dense_init(gen: torch.Generator, shape, in_axis_size: Optional[int] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (+-2 std) fan-in init (LeCun-style), by inverting
    the normal CDF of a uniform draw; above WHOLE_DRAW_BYTES of f32, one
    slice of the first axis at a time (other numbers from the same
    generator, the same distribution)."""
    if in_axis_size is None:
        in_axis_size = shape[0]
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    if 4 * math.prod(shape) <= WHOLE_DRAW_BYTES:
        return _truncated_normal(gen, shape, std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = _truncated_normal(gen, shape[1:], std)
    return out


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device, dtype=torch.float32,
                 zero_centered: bool = True):
    # gemma-style zero-centred scale: weight stored as (scale - 1)
    fill = torch.zeros if zero_centered else torch.ones
    return {"scale": fill((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if zero_centered:
        scale = scale + 1.0
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), d_model, dtype),
        "w_up": dense_init(gen, (d_model, d_ff), d_model, dtype),
        "w_down": dense_init(gen, (d_ff, d_model), d_ff, dtype),
    }


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "geglu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    return F.silu(x)  # swiglu


def mlp(params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """x (..., d) -> (..., d).  On DTensors each rank computes its rows'
    share of the hidden width (``pctx.local_call``, as the "ffn_hidden"
    hint places it, the weights gathered over their FSDP axis) and the
    down projection's partial sums are added over the hidden's axis: the
    column- then row-parallel MLP of Megatron."""
    dtype = x.dtype
    w = [cast(params[k], dtype) for k in ("w_gate", "w_up", "w_down")]

    def ffn(x, w_gate, w_up, w_down):
        gate = x @ w_gate
        up = x @ w_up
        h = _act(gate, activation) * up
        return h @ w_down
    if not pctx.is_dtensor(x):
        return ffn(x, *w)
    key = "ffn_hidden" if x.ndim == 3 else "ffn_hidden_2d"
    spec = pctx.spec_of(key, x.ndim)
    if pctx.hint(key) is None:
        spec = pctx.spec_of("activations", 3)[: x.ndim - 1] + (None,)
    rows, hid = spec[:-1], spec[-1]
    axes = (hid,) if isinstance(hid, str) else tuple(hid or ())
    return pctx.local_call(ffn, (x, *w), (rows + (None,), (None, hid),
                                           (None, hid), (hid, None)),
                           rows + (None,), partial=axes)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # the base filled on the device, not copied from the host, so that a
    # decode step captured in a CUDA graph makes no host-to-device copy
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim); positions broadcastable to
    (..., seq)."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * inv_freq   # (..., S, half)
    angles = angles[..., None, :]          # (..., S, 1, half) over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def write_state(state: dict, key: str, value: torch.Tensor,
                slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A decode step's write into its cache, in place, so that every entry
    keeps its address (a step captured in a CUDA graph reads and writes
    them there at every replay): ``state[key]`` set to `value`, cast to
    the entry's dtype, or with `slot` (B,) its row ``slot[b]`` of each
    batch row b set to ``value[b, 0]``.  Returns the entry."""
    buf = state[key]
    if slot is None:
        return buf.copy_(value)
    bidx = torch.arange(buf.shape[0], device=buf.device)
    buf[bidx, slot] = value[:, 0]
    return buf


# ---------------------------------------------------------------------------
# Softcapping
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32):
    return {"table": embed_init(gen, (vocab, d_model), dtype)}


def embed(params, tokens: torch.Tensor, scale: bool, d_model: int,
          dtype=torch.bfloat16) -> torch.Tensor:
    """The rows of the table for `tokens`.  On DTensors each rank looks up
    its own tokens' rows (``pctx.local_call``; the table whole on every
    rank, as its rule keeps it), the gradient summed over the ranks."""
    if pctx.is_dtensor(tokens):
        rows = (pctx.activation_rows(3)[0],) + (None,) * (tokens.ndim - 1)
        return pctx.local_call(
            lambda table, tokens: embed({"table": table}, tokens, scale,
                                        d_model, dtype),
            (params["table"], tokens), ((), rows), rows + (None,))
    x = params["table"][tokens].to(dtype)
    if scale:
        # sqrt(d_model) rounded to the compute dtype first, as the
        # reference does (bf16 turns 50.596 into 50.5); filled on the
        # device, as ``rope_frequencies``' base
        x = x * torch.full((), math.sqrt(d_model), dtype=dtype,
                           device=x.device)
    return x


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_model) -> logits (..., vocab)."""
    return x @ cast(params["table"], x.dtype).T
