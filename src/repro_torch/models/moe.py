"""Mixture-of-Experts FFN with two dispatch strategies (port of
``repro.models.moe``).

``einsum``   GShard-style dense one-hot dispatch/combine tensors — the
             paper-faithful / textbook baseline.  O(N·E·C) dispatch tensors.
``sort``     scatter-based dispatch into fixed (E, C, d) buffers — the
             optimized variant (no N·E·C one-hots; a scatter + gather pair).

``gshard:G`` and ``sortg:G`` are their grouped forms: tokens in G groups,
capacity per group.  All are capacity-based (tokens over capacity are
dropped) and numerically equivalent for kept tokens.  Experts are stacked
on a leading E axis; the expert products are batched matmuls, which the
reference also leaves to the compiler outside any Pallas kernel.

Routing is in f32 (the router weights stay f32 under bf16 parameters).
Ties between gates take the lower expert index first, as
``jax.lax.top_k`` does: ``torch.topk`` leaves the order of equal values
unspecified, so the router sorts stably instead.  The reference's
``pctx.constrain`` hints are the identity on one device and are dropped.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import _act, dense_init, mlp, mlp_init, softcap


def moe_init(gen: torch.Generator, d_model: int, moe, dtype=torch.float32):
    E, Fd = moe.n_experts, moe.d_ff_expert
    p = {
        "w_router": dense_init(gen, (d_model, E), d_model, torch.float32),
        "w_gate": dense_init(gen, (E, d_model, Fd), d_model, dtype),
        "w_up": dense_init(gen, (E, d_model, Fd), d_model, dtype),
        "w_down": dense_init(gen, (E, Fd, d_model), Fd, dtype),
    }
    if moe.n_shared_experts:
        dff_sh = moe.d_ff_shared or moe.d_ff_expert * moe.n_shared_experts
        p["shared"] = mlp_init(gen, d_model, dff_sh, dtype)
    return p


def _router(params, x2d: torch.Tensor, moe):
    """x2d: (N, d) -> (weights (N, k) f32, experts (N, k), gates (N, E)
    f32), routing in f32.  The top k by a stable descending sort: equal
    gates keep the lower expert index first, as ``jax.lax.top_k``."""
    logits = x2d.float() @ params["w_router"].float()
    if moe.router_softcap:
        logits = softcap(logits, moe.router_softcap)
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = w[:, :moe.top_k], idx[:, :moe.top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, idx, gates


def _capacity(n_tokens: int, moe) -> int:
    c = int(math.ceil(n_tokens * moe.top_k / moe.n_experts
                      * moe.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8


def _positions_in_expert(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idx: (N, k) expert ids -> (N, k) arrival order within each expert,
    counted over the token-major (N*k,) flattening.

    The reference takes a cumsum of the (N*k, E) one-hot down the
    assignments; this computes the same integers with a stable sort by
    expert (which keeps arrival order within each expert), each
    assignment's rank after its expert's first, scattered back.  It
    neither materialises the one-hot nor scans down its long axis, and
    nothing in it waits on the device."""
    N, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(n_experts, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(flat.numel(), device=flat.device) - \
        starts[flat[order]]
    pos = torch.empty_like(flat)
    pos[order] = rank
    return pos.reshape(N, k)


def _expert_ffn(params, buf: torch.Tensor, activation: str) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d) via per-expert gated MLP."""
    dtype = buf.dtype
    g = torch.bmm(buf, params["w_gate"].to(dtype))
    u = torch.bmm(buf, params["w_up"].to(dtype))
    h = _act(g, activation) * u
    return torch.bmm(h, params["w_down"].to(dtype))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return F.one_hot(idx, n).to(dtype)


def _group_positions(idxg: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idxg: (G, n, k) -> (G, n, k) arrival order within each expert,
    counted per group over its token-major (n*k,) flattening: each
    (group, expert) pair counted as an expert of its own."""
    G, n, k = idxg.shape
    offset = n_experts * torch.arange(G, device=idxg.device)[:, None, None]
    pos = _positions_in_expert((idxg + offset).reshape(G * n, k),
                               G * n_experts)
    return pos.reshape(G, n, k)


def _gshard_grouped(params, x2d, moe, activation: str, G: int):
    """GShard grouped dense dispatch: tokens in G groups, capacity per
    group, dispatch / combine one-hots with an explicit group axis."""
    N, d = x2d.shape
    if N % G:
        raise ValueError(f"{N} tokens do not split into {G} groups")
    n = N // G
    E, k = moe.n_experts, moe.top_k
    C = _capacity(n, moe)
    w, idx, _ = _router(params, x2d, moe)
    xg = x2d.reshape(G, n, d)
    wg, idxg = w.reshape(G, n, k), idx.reshape(G, n, k)
    pos = _group_positions(idxg, E)
    keep = pos < C
    wg = torch.where(keep, wg, torch.zeros_like(wg)).to(x2d.dtype)
    oh_e = _one_hot(idxg, E, x2d.dtype)                      # (G, n, k, E)
    oh_c = _one_hot(torch.where(keep, pos, C), C + 1,
                    x2d.dtype)[..., :-1]                     # (G, n, k, C)
    disp = torch.einsum("gnke,gnkc->gnec", oh_e, oh_c)
    expert_in = torch.einsum("gnec,gnd->egcd", disp, xg)
    eo = _expert_ffn(params, expert_in.reshape(E, G * C, d), activation)
    eo = eo.reshape(E, G, C, d)
    comb = torch.einsum("gnke,gnkc,gnk->gnec", oh_e, oh_c, wg)
    out = torch.einsum("gnec,egcd->gnd", comb, eo)
    return out.reshape(N, d)


def _sort_grouped(params, x2d, moe, activation: str, G: int):
    """Grouped scatter dispatch: each group scatters its tokens into its
    own (E, C, d) buffer, the experts compute on the (E, G * C, d)
    expert-major view, and each group gathers its rows back."""
    N, d = x2d.shape
    if N % G:
        raise ValueError(f"{N} tokens do not split into {G} groups")
    n = N // G
    E, k = moe.n_experts, moe.top_k
    C = _capacity(n, moe)
    w, idx, _ = _router(params, x2d, moe)
    xg = x2d.reshape(G, n, d)
    wg, idxg = w.reshape(G, n, k), idx.reshape(G, n, k)
    pos = _group_positions(idxg, E)
    keep = pos < C
    wg = torch.where(keep, wg, torch.zeros_like(wg)).to(x2d.dtype)
    pos_c = torch.where(keep, pos, C).reshape(G, n * k)  # overflow row C
    gi = torch.arange(G, device=x2d.device)[:, None].expand(G, n * k)
    ei = idxg.reshape(G, n * k)
    bufs = x2d.new_zeros((G, E, C + 1, d))
    # several dropped assignments may write the overflow row C; it is
    # sliced away, so which of them lands there does not matter
    bufs[gi, ei, pos_c] = xg.repeat_interleave(k, dim=1)
    ein = bufs[:, :, :C].transpose(0, 1)                  # (E, G, C, d)
    eo = _expert_ffn(params, ein.reshape(E, G * C, d), activation)
    eo_g = eo.reshape(E, G, C, d).transpose(0, 1)
    eo_g = torch.cat([eo_g, x2d.new_zeros((G, E, 1, d))], dim=2)
    g = eo_g[gi, ei, pos_c].reshape(G, n, k, d)
    out = torch.einsum("gnkd,gnk->gnd", g, wg)
    return out.reshape(N, d)


def moe_forward(params, x: torch.Tensor, moe, activation: str = "swiglu",
                dispatch: Optional[str] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  The load-balance loss is apart, in
    ``moe_aux_loss``.  `dispatch`: "einsum", "sort", "gshard:G" or
    "sortg:G" (``moe.dispatch`` when None)."""
    B, S, d = x.shape
    N = B * S
    x2d = x.reshape(N, d)
    method = dispatch or moe.dispatch

    if method.startswith("gshard") or method.startswith("sortg"):
        groups = int(method.split(":")[1]) if ":" in method else 1
        fn = _sort_grouped if method.startswith("sortg") else \
            _gshard_grouped
        out = fn(params, x2d, moe, activation, groups)
        if "shared" in params:
            out = out + mlp(params["shared"], x2d, activation)
        return out.reshape(B, S, d)
    if method not in ("einsum", "sort"):
        raise ValueError(f"unknown MoE dispatch {method!r}")

    w, idx, _ = _router(params, x2d, moe)
    C = _capacity(N, moe)
    E = moe.n_experts

    pos = _positions_in_expert(idx, E)
    keep = pos < C
    w = torch.where(keep, w, torch.zeros_like(w)).to(x.dtype)

    if method == "einsum":
        # GShard: dense one-hot dispatch (N, E, C) and combine tensors.
        disp = _per_k_disp(idx, pos, keep, E, C, x.dtype).sum(dim=1)
        expert_in = torch.einsum("nec,nd->ecd", disp, x2d)
        expert_out = _expert_ffn(params, expert_in, activation)
        if moe.top_k == 1:
            combine = disp * w.sum(dim=1)[:, None, None]
        else:
            combine = torch.einsum("nkec,nk->nec",
                                   _per_k_disp(idx, pos, keep, E, C,
                                               x.dtype), w)
        out = torch.einsum("nec,ecd->nd", combine, expert_out)
    else:
        # sort/scatter: build (E, C, d) buffers with a scatter, gather back.
        pos_c = torch.where(keep, pos, C)        # dropped -> overflow row
        buf = x2d.new_zeros((E, C + 1, d))
        # several dropped assignments may write the overflow row C (the
        # reference's scatter keeps one of them too); it is sliced away
        # before the experts run, so which lands there does not matter
        buf[idx.reshape(-1), pos_c.reshape(-1)] = \
            x2d.repeat_interleave(moe.top_k, dim=0)
        expert_out = _expert_ffn(params, buf[:, :C], activation)
        expert_out = torch.cat([expert_out, x2d.new_zeros((E, 1, d))],
                               dim=1)
        gathered = expert_out[idx.reshape(-1), pos_c.reshape(-1)]
        out = torch.einsum("nkd,nk->nd",
                           gathered.reshape(N, moe.top_k, d), w)

    if "shared" in params:
        out = out + mlp(params["shared"], x2d, activation)
    return out.reshape(B, S, d)


def _per_k_disp(idx, pos, keep, E: int, C: int, dtype) -> torch.Tensor:
    """(N, k, E, C) per-assignment one-hot (the einsum dispatch)."""
    oh_e = _one_hot(idx, E, dtype)                       # (N, k, E)
    oh_c = _one_hot(torch.where(keep, pos, C), C + 1,
                    dtype)[..., :-1]                     # (N, k, C)
    return oh_e[..., :, None] * oh_c[..., None, :]


def moe_aux_loss(params, x: torch.Tensor, moe) -> torch.Tensor:
    """GShard load-balance auxiliary loss (mean gate * mean assignment)."""
    d = x.shape[-1]
    _, idx, gates = _router(params, x.reshape(-1, d), moe)
    me = gates.mean(dim=0)
    ce = F.one_hot(idx[:, 0], moe.n_experts).float().mean(dim=0)
    return moe.n_experts * torch.sum(me * ce)
