"""Mamba-2 SSD (state-space duality) block, port of ``repro.models.ssd``.

The block: a fused in-projection to [z, xBC, dt], a depthwise causal
conv and SiLU over xBC, the SSD scan over heads of ``head_dim`` with a
state of ``d_state`` per head, a D skip, a SiLU(z) gate with RMSNorm and
an out-projection.

Prefill runs the scan through ``kernels.ops.ssd_op``, the hand-written
chunked scan on the card, where the reference calls its jnp
``ssd_chunked``: the same function, chunked and summed in another order,
so the two agree to rounding.  The kernel reads B and C per group, so
they are not repeated to every head.  Its state is f32; the cache keeps
it in the compute dtype, as the reference's is.  Decode is one step of
the recurrence in plain PyTorch.

Given the state of an earlier part of the prompt, ``ssd_forward``
continues the conv as well as the scan (as ``rglru_forward`` does), so a
split prompt equals one pass; the reference seeds only the scan there,
on a path none of its callers takes.

Shapes: x (B, S, d_model); inner width di = expand * d_model; heads
nh = di / head_dim; state n = d_state; groups g (B and C shared across
nh / g heads).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import pctx
from .layers import cast, dense_init, rmsnorm, rmsnorm_init, write_state


def ssd_init(gen: torch.Generator, d_model: int, ssd, dtype=torch.float32):
    """Matmul weights, the conv and the gate norm in `dtype`; A_log, D and
    dt_bias stay f32 whatever the weights' dtype."""
    dev = gen.device
    di = ssd.d_inner(d_model)
    nh = ssd.n_heads(d_model)
    g = ssd.n_groups
    conv_ch = di + 2 * g * ssd.d_state
    w_in = dense_init(gen, (d_model, 2 * di + 2 * g * ssd.d_state + nh),
                      d_model, dtype)
    conv_w = dense_init(gen, (ssd.conv_width, conv_ch), ssd.conv_width, dtype)
    u = torch.empty((nh,), dtype=torch.float32, device=dev).uniform_(
        generator=gen)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        # fused in-proj: [z(di), xBC(conv_ch), dt(nh)]
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "gate_norm": rmsnorm_init(di, dev, dtype),
        "w_out": dense_init(gen, (di, d_model), di, dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv, x: (B, S, C), w: (W, C) -> (B, S, C)."""
    W = w.shape[0]
    S = x.shape[1]
    out = x * w[-1] + b
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out


def _heads(xBC, di: int, g: int, n: int, nh: int, hd: int):
    """Split the conv'd xBC (..., conv_ch) into x (..., nh, hd) and B, C
    (..., g, n)."""
    lead = xBC.shape[:-1]
    xs = xBC[..., :di].reshape(*lead, nh, hd)
    Bg = xBC[..., di: di + g * n].reshape(*lead, g, n)
    Cg = xBC[..., di + g * n:].reshape(*lead, g, n)
    return xs, Bg, Cg


def _forward_shards(params, x, ssd, eps, state, return_state: bool,
                    use_kernel: bool):
    """``ssd_forward`` on each rank's batch rows (``pctx.local_block``),
    its weights gathered: the in-projection's channels interleave the
    heads' x, B, C and dt, and the gate's norm spans every head, so the
    block is not split over "model"; the states likewise."""
    rows = pctx.activation_rows(3)
    st_specs = ((rows[0], None, None, None), rows)
    extra = () if state is None else (state["h"], state["conv"])

    def block(p, x, *st):
        st = {"h": st[0], "conv": st[1]} if st else None
        got = ssd_forward(p, x, ssd, eps, st, return_state, use_kernel)
        return (got[0], got[1]["h"], got[1]["conv"]) if return_state \
            else got
    whole = lambda path, t: (None,) * t.ndim
    if not return_state:
        return pctx.local_block(block, params, x, whole, rows, extra=extra,
                                extra_specs=st_specs[:len(extra)])
    out, h, conv = pctx.local_block(block, params, x, whole,
                                    [rows, *st_specs], extra=extra,
                                    extra_specs=st_specs[:len(extra)])
    return out, {"h": h, "conv": conv}


def ssd_forward(params, x, ssd, eps: float = 1e-6, state=None,
                return_state: bool = False, use_kernel: bool = True):
    """Full-sequence Mamba-2 block. x: (B, S, d_model).  `state` (the
    decode state of an earlier chunk of the prompt) seeds the scan;
    ``return_state`` also returns {"h": (B, nh, hd, n), "conv":
    (B, cw-1, conv_ch)} in the compute dtype.  On DTensors the whole
    block runs on each rank's batch rows (``_forward_shards``)."""
    if pctx.is_dtensor(x):
        return _forward_shards(params, x, ssd, eps, state, return_state,
                               use_kernel)
    Bsz, S, d = x.shape
    dtype = x.dtype
    di = ssd.d_inner(d)
    nh = ssd.n_heads(d)
    g, n = ssd.n_groups, ssd.d_state

    zxbcdt = x @ cast(params["w_in"], dtype)
    z = zxbcdt[..., :di]
    xBC_raw = zxbcdt[..., di: di + di + 2 * g * n]
    dt_raw = zxbcdt[..., -nh:]

    conv_w = cast(params["conv_w"], dtype)
    conv_b = cast(params["conv_b"], dtype)
    if state is not None:
        # continue the conv across the boundary
        n_prev = state["conv"].shape[1]
        xBC_raw = torch.cat([state["conv"].to(dtype), xBC_raw], dim=1)
        xBC = F.silu(_causal_conv(xBC_raw, conv_w, conv_b)[:, n_prev:])
    else:
        xBC = F.silu(_causal_conv(xBC_raw, conv_w, conv_b))
    xs, Bg, Cg = _heads(xBC, di, g, n, nh, ssd.head_dim)

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    h0 = None if state is None else state["h"].float().contiguous()
    y, h_final = ops.ssd_op(xs, dt, A, Bg, Cg, h0, chunk=ssd.chunk,
                            use_kernel=use_kernel)
    y = y + xs * cast(params["D"], dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, di)
    y = rmsnorm(params["gate_norm"], y * F.silu(z), eps)
    out = y @ cast(params["w_out"], dtype)
    if return_state:
        return out, {"h": h_final.to(dtype),
                     "conv": xBC_raw_tail(xBC_raw, ssd.conv_width)}
    return out


def xBC_raw_tail(xBC_raw, conv_width: int):
    """Last (conv_width-1) pre-conv xBC inputs (B, S, conv_ch), zero-padded
    in front when S is shorter, for decode continuation.  (The reference
    slices them out of the fused projection; here the caller passes the
    xBC rows, which after a carried state include the earlier ones.)"""
    W = conv_width - 1
    S = xBC_raw.shape[1]
    if S >= W:
        return xBC_raw[:, S - W:].contiguous()
    return F.pad(xBC_raw, (0, 0, W - S, 0))


def ssd_decode(params, x, state, ssd, eps: float = 1e-6):
    """Single-token step. x: (B, 1, d); state: {"h": (B, nh, hd, n),
    "conv": (B, conv_width-1, conv_ch)}.  Returns (out, state), the
    state's entries written in place, as ``rglru_decode``'s.  On DTensors
    the step runs on each rank's batch rows, the weights gathered, as
    ``ssd_forward``'s forward."""
    if pctx.is_dtensor(x):
        rows = pctx.activation_rows(3)

        def block(p, x, h, conv):
            out, st = ssd_decode(p, x, {"h": h, "conv": conv}, ssd, eps)
            return out, st["h"], st["conv"]
        h4 = (rows[0], None, None, None)
        out, h, conv = pctx.local_block(
            block, params, x, lambda path, t: (None,) * t.ndim,
            [rows, h4, rows], extra=(state["h"], state["conv"]),
            extra_specs=(h4, rows))
        return out, {"h": h, "conv": conv}
    Bsz, _, d = x.shape
    dtype = x.dtype
    di = ssd.d_inner(d)
    nh = ssd.n_heads(d)
    g, n = ssd.n_groups, ssd.d_state

    zxbcdt = x @ cast(params["w_in"], dtype)
    z = zxbcdt[..., :di]
    xBC_new = zxbcdt[:, 0, di: di + di + 2 * g * n]
    dt_raw = zxbcdt[..., -nh:]

    conv_buf = torch.cat([state["conv"], xBC_new[:, None]], dim=1)
    w = cast(params["conv_w"], dtype)
    xBC = (torch.einsum("bwc,wc->bc", conv_buf, w)
           + cast(params["conv_b"], dtype))
    xBC = F.silu(xBC)

    xs, Bg, Cg = _heads(xBC, di, g, n, nh, ssd.head_dim)
    Bh = Bg.repeat_interleave(nh // g, dim=1)
    Ch = Cg.repeat_interleave(nh // g, dim=1)

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B, nh)
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt * A)                                     # (B, nh)

    h = (state["h"].float() * dA[..., None, None]
         + torch.einsum("bh,bhp,bhn->bhpn", dt, xs.float(), Bh.float()))
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), h)
    y = y.to(dtype) + xs * cast(params["D"], dtype)[None, :, None]
    y = y.reshape(Bsz, 1, di)
    y = rmsnorm(params["gate_norm"], y * F.silu(z), eps)
    out = y @ cast(params["w_out"], dtype)
    write_state(state, "h", h)
    write_state(state, "conv", conv_buf[:, 1:])
    return out, state
