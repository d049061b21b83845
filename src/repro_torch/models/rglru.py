"""RG-LRU recurrent block (RecurrentGemma / Griffin), port of
``repro.models.rglru``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
r_t, i_t: block-diagonal linear gates over the conv'd input.

Prefill runs the recurrence through ``kernels.ops.rglru_op``, the
hand-written serial scan on the card, where the reference calls its
``associative_scan`` (``lru_scan``): the same recurrence, summed in
another order, so the two agree to f32 rounding, not bitwise.  Decode is
one step of the recurrence in plain PyTorch.  In a mesh step the block
runs on each rank's shards (``_forward_shards``, ``_decode_shards``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import pctx
from .layers import cast, dense_init, write_state

_C = 8.0


def rglru_init(gen: torch.Generator, d_model: int, n_heads: int, rglru,
               dtype=torch.float32):
    dev = gen.device
    w = rglru.lru_width or d_model
    nb = n_heads
    bw = w // nb
    # Lambda init so that a^c in (0.9, 0.999) at r=1 (Griffin appendix);
    # a_param stays f32 whatever the weights' dtype
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    a_param = torch.log(torch.expm1(-(1.0 / _C) * torch.log(u)))
    return {
        "w_x": dense_init(gen, (d_model, w), d_model, dtype),
        "w_gate_branch": dense_init(gen, (d_model, w), d_model, dtype),
        "conv_w": dense_init(gen, (rglru.conv_width, w), rglru.conv_width,
                             dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_r": dense_init(gen, (nb, bw, bw), bw, dtype),
        "b_r": torch.zeros((w,), dtype=dtype, device=dev),
        "w_i": dense_init(gen, (nb, bw, bw), bw, dtype),
        "b_i": torch.zeros((w,), dtype=dtype, device=dev),
        "a_param": a_param,
        "w_out": dense_init(gen, (w, d_model), w, dtype),
    }


def _block_diag(x, w, b, nb):
    """x: (..., W) with W = nb*bw; w: (nb, bw, bw)."""
    shape = x.shape
    xb = x.reshape(*shape[:-1], nb, -1)
    out = torch.einsum("...nb,nbc->...nc", xb, w)
    return out.reshape(shape) + b


def _gates(params, u, nb):
    dtype = u.dtype
    r = torch.sigmoid(_block_diag(u, cast(params["w_r"], dtype),
                                  cast(params["b_r"], dtype), nb).float())
    i = torch.sigmoid(_block_diag(u, cast(params["w_i"], dtype),
                                  cast(params["b_i"], dtype), nb).float())
    log_a = -_C * r * F.softplus(params["a_param"].float())
    a = torch.exp(log_a)
    # sqrt(1 - a^2) in f32, clipped for stability near a=1
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated_in = i * u.float()
    return a, beta * gated_in


def _causal_conv(x, w, b):
    W = w.shape[0]
    S = x.shape[1]
    out = x * w[-1] + b
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out


def _gelu(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def rglru_forward(params, x, n_heads: int, rglru, state=None,
                  return_state: bool = False, use_kernel: bool = True):
    """x: (B, S, d_model) -> (B, S, d_model); with ``return_state`` also
    the decode state {"h": (B, W) f32, "conv": (B, cw-1, W)}.  On
    DTensors the block runs on each rank's shards (``_forward_shards``)."""
    if pctx.is_dtensor(x):
        return _forward_shards(params, x, n_heads, rglru, use_kernel,
                               state, return_state)
    dtype = x.dtype
    gate = _gelu(x @ cast(params["w_gate_branch"], dtype))
    u_raw = x @ cast(params["w_x"], dtype)
    conv_w = cast(params["conv_w"], dtype)
    conv_b = cast(params["conv_b"], dtype)
    if state is not None:
        # continue the conv across the prefill boundary
        n_prev = state["conv"].shape[1]
        buf = torch.cat([state["conv"].to(dtype), u_raw], dim=1)
        u = _causal_conv(buf, conv_w, conv_b)[:, n_prev:]
    else:
        u = _causal_conv(u_raw, conv_w, conv_b)
    a, b = _gates(params, u, n_heads)
    h0 = None if state is None else state["h"].float().contiguous()
    h = ops.rglru_op(a.contiguous(), b.contiguous(), h0,
                     use_kernel=use_kernel).to(dtype)
    out = (h * gate) @ cast(params["w_out"], dtype)
    if return_state:
        W = rglru.conv_width - 1
        S = u_raw.shape[1]
        tail = (u_raw[:, S - W:] if S >= W
                else F.pad(u_raw, (0, 0, W - S, 0)))
        return out, {"h": h[:, -1].float(), "conv": tail.contiguous()}
    return out


def _split(params, x, n_heads: int):
    """(channel entry, local blocks, parameter specs) of the RG-LRU on
    each rank's shards: the LRU channels split over "model" where that
    divides both the width and the gates' blocks (the channels' weights,
    biases and blocks with them, the input projections gathered)."""
    from ..distributed.sharding import axis_names, axis_size
    mesh = x.device_mesh
    nm = axis_size(mesh, "model")
    ch = ("model" if "model" in axis_names(mesh) and n_heads % nm == 0
          and params["w_x"].shape[1] % nm == 0 else None)
    nb = n_heads // nm if ch else n_heads

    def pspec(path, t):
        name = path.split("/")[0]
        if name in ("w_x", "w_gate_branch", "conv_w"):
            return (None, ch)
        if name in ("w_r", "w_i"):
            return (ch, None, None)
        if name == "w_out":
            return (ch, None)
        return (ch,) if t.ndim == 1 else (None,) * t.ndim
    return ch, nb, pspec


def _forward_shards(params, x, n_heads: int, rglru, use_kernel: bool,
                    state=None, return_state: bool = False):
    """``rglru_forward`` on each rank's shards (``pctx.local_block``, as
    ``_split`` splits it); the output projection's partial sums added
    over "model", the states' channels as the block splits them."""
    ch, nb, pspec = _split(params, x, n_heads)
    rows = pctx.activation_rows(3)
    part = (ch,) if ch else ()
    st_specs = ((rows[0], ch), (rows[0], None, ch))
    extra = () if state is None else (state["h"], state["conv"])

    def block(p, x, *st):
        st = {"h": st[0], "conv": st[1]} if st else None
        got = rglru_forward(p, x, nb, rglru, st, return_state, use_kernel)
        return (got[0], got[1]["h"], got[1]["conv"]) if return_state \
            else got
    if not return_state:
        return pctx.local_block(block, params, x, pspec, rows,
                                partial=part, extra=extra,
                                extra_specs=st_specs[:len(extra)])
    out, h, conv = pctx.local_block(
        block, params, x, pspec, [rows, *st_specs], partial=[part, (), ()],
        extra=extra, extra_specs=st_specs[:len(extra)])
    return out, {"h": h, "conv": conv}


def _decode_shards(params, x, state, n_heads: int, rglru):
    ch, nb, pspec = _split(params, x, n_heads)
    rows = pctx.activation_rows(3)

    def block(p, x, h, conv):
        out, st = rglru_decode(p, x, {"h": h, "conv": conv}, nb, rglru)
        return out, st["h"], st["conv"]
    out, h, conv = pctx.local_block(
        block, params, x, pspec, [rows, (rows[0], ch), (rows[0], None, ch)],
        partial=[(ch,) if ch else (), (), ()],
        extra=(state["h"], state["conv"]),
        extra_specs=((rows[0], ch), (rows[0], None, ch)))
    return out, {"h": h, "conv": conv}


def rglru_decode(params, x, state, n_heads: int, rglru):
    """x: (B, 1, d); state: {"h": (B, W) f32, "conv": (B, cw-1, W)}.
    Returns (out, state), the state's entries written in place (a decode
    step captured in a CUDA graph reads them at the same addresses at
    every replay).  On DTensors the step runs on each rank's shards, split
    as ``_forward_shards`` splits the forward."""
    if pctx.is_dtensor(x):
        return _decode_shards(params, x, state, n_heads, rglru)
    dtype = x.dtype
    gate = _gelu(x @ cast(params["w_gate_branch"], dtype))
    u_new = (x @ cast(params["w_x"], dtype))[:, 0]
    buf = torch.cat([state["conv"].to(dtype), u_new[:, None]], dim=1)
    u = (torch.einsum("bwc,wc->bc", buf, cast(params["conv_w"], dtype))
         + cast(params["conv_b"], dtype))
    a, b = _gates(params, u[:, None], n_heads)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = (h[:, None].to(dtype) * gate) @ cast(params["w_out"], dtype)
    write_state(state, "h", h)
    write_state(state, "conv", buf[:, 1:])
    return out, state
