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
unspecified, so the router sorts stably instead.  A mesh step's DTensors
take ``_moe_shards``, each rank its own groups and experts, placed as the
"moe_expert_in" hint names them (``_moe_entries``): the reference's
``pctx.constrain`` calls inside the dispatch have no counterpart, since
no DTensor reaches it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import pctx
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


def _gshard_tables(w_router, x2d, moe, n: int):
    """The dispatch and combine one-hots (G, n, E, C) of x2d's tokens in
    groups of n: routing and arrival order are each group's own."""
    N, d = x2d.shape
    G = N // n
    E, k = moe.n_experts, moe.top_k
    C = _capacity(n, moe)
    w, idx, _ = _router({"w_router": w_router}, x2d, moe)
    wg, idxg = w.reshape(G, n, k), idx.reshape(G, n, k)
    pos = _group_positions(idxg, E)
    keep = pos < C
    wg = torch.where(keep, wg, torch.zeros_like(wg)).to(x2d.dtype)
    oh_e = _one_hot(idxg, E, x2d.dtype)                      # (G, n, k, E)
    oh_c = _one_hot(torch.where(keep, pos, C), C + 1,
                    x2d.dtype)[..., :-1]                     # (G, n, k, C)
    disp = torch.einsum("gnke,gnkc->gnec", oh_e, oh_c)
    comb = torch.einsum("gnke,gnkc,gnk->gnec", oh_e, oh_c, wg)
    return disp, comb


def _sort_scatter(w_router, x2d, moe, n: int):
    """Each group of n tokens scattered into its own (E, C, d) buffer ->
    (bufs (G, E, C, d), the combine weights (G, n, k), the experts
    (G, n * k) and rows (G, n * k) of the assignments, C for dropped)."""
    N, d = x2d.shape
    G = N // n
    E, k = moe.n_experts, moe.top_k
    C = _capacity(n, moe)
    w, idx, _ = _router({"w_router": w_router}, x2d, moe)
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
    return bufs[:, :, :C], wg, ei, pos_c


def _sort_gather(eo_g, wg, ei, pos_c):
    """Each group's rows gathered back from its (E, C, d) expert outputs
    and combined -> (G * n, d)."""
    G, E, _, d = eo_g.shape
    n, k = wg.shape[1], wg.shape[2]
    eo_g = torch.cat([eo_g, eo_g.new_zeros((G, E, 1, d))], dim=2)
    gi = torch.arange(G, device=eo_g.device)[:, None].expand(G, n * k)
    g = eo_g[gi, ei, pos_c].reshape(G, n, k, d)
    return torch.einsum("gnkd,gnk->gnd", g, wg).reshape(G * n, d)


def _grouped(params, x2d, moe, activation: str, n: int, sort: bool,
             e0: int = 0, e_l: Optional[int] = None):
    """The grouped dispatch of x2d's tokens in groups of n: "gshard:G"'s
    dense dispatch / combine one-hots, or with `sort` "sortg:G"'s
    per-group scatter into (E, C, d) buffers and gather back.  Routing,
    capacity and arrival order are each group's own, over every expert;
    experts e0 .. e0 + e_l (all of them by default, their weights in
    `params`) compute on the expert-major (e_l, G * C, d) view and are
    combined.  One device runs every expert; a mesh rank its own
    (``_moe_shards``), whose partial sums are added over the experts'
    axis."""
    N, d = x2d.shape
    if N % n:
        raise ValueError(f"{N} tokens do not split into groups of {n}")
    e_l = moe.n_experts - e0 if e_l is None else e_l
    if sort:
        bufs, wg, ei, pos_c = _sort_scatter(params["w_router"], x2d, moe, n)
        G, _, C, _ = bufs.shape
        ein = bufs[:, e0:e0 + e_l].transpose(0, 1)
        eo = _expert_ffn(params, ein.reshape(e_l, G * C, d), activation)
        eo_g = bufs.new_zeros(bufs.shape)
        eo_g[:, e0:e0 + e_l] = eo.reshape(e_l, G, C, d).transpose(0, 1)
        return _sort_gather(eo_g, wg, ei, pos_c)
    disp, comb = _gshard_tables(params["w_router"], x2d, moe, n)
    G, _, _, C = disp.shape
    xg = x2d.reshape(G, n, d)
    ein = torch.einsum("gnec,gnd->egcd", disp[:, :, e0:e0 + e_l], xg)
    eo = _expert_ffn(params, ein.reshape(e_l, G * C, d), activation)
    out = torch.einsum("gnec,egcd->gnd", comb[:, :, e0:e0 + e_l],
                       eo.reshape(e_l, G, C, d))
    return out.reshape(N, d)


def _moe_entries(mesh, G: int, E: int):
    """(group entry, expert entry): the groups on the DP axes and the
    experts on "model", as the "moe_expert_in" hint places them, where
    they divide (the groups on the DP axes when those divide G, else
    replicated).  Each rank multiplies whole rows: a hint that splits the
    capacity or the model width (the dry run's ``moe_dshard``, expert
    weights kept sharded on d) raises."""
    from ..distributed.sharding import axis_names, axis_size, dp_entry
    if pctx.hint("moe_expert_in") is not None:
        es = pctx.spec_of("moe_expert_in", 4)
        if es[2] is not None or es[3] is not None:
            raise NotImplementedError(
                f"moe_expert_in {es}: a split capacity or model width "
                "(moe_dshard) is not implemented in the port's MoE")
        return es[1], es[0]
    em = ("model" if "model" in axis_names(mesh)
          and E % axis_size(mesh, "model") == 0 else None)
    return dp_entry(mesh, G), em


def _moe_shards(params, x, moe, activation: str, method: str, G: int):
    """The grouped dispatch ("gshard:G" or "sortg:G") of DTensor `x` (B,
    S, d), each rank on its shards (``pctx.local_call``): its groups'
    tokens (the groups on the DP axes), the routing, capacity and arrival
    order over every expert, and its own experts (on "model", their
    weights gathered over their FSDP axis) computed and combined; the
    combine's partial sums are added over the experts' axis.  With the
    groups on the DP axes and the experts on "model" no token moves
    between ranks: each rank already holds its groups' tokens for every
    expert."""
    from ..distributed.sharding import axis_size
    B, S, d = x.shape
    N = B * S
    if N % G:
        raise ValueError(f"{N} tokens do not split into {G} groups")
    n = N // G
    E = moe.n_experts
    mesh = x.device_mesh
    dp, em = _moe_entries(mesh, G, E)
    e_l = E // axis_size(mesh, em) if em else E
    e0 = mesh.get_local_rank(em) * e_l if em else 0
    sort = method.startswith("sortg")

    def layer(x, w_router, w_gate, w_up, w_down):
        p = {"w_router": w_router, "w_gate": w_gate, "w_up": w_up,
             "w_down": w_down}
        return _grouped(p, x.reshape(-1, d), moe, activation, n, sort, e0,
                        e_l).reshape(x.shape)
    rows = (dp, None, None)
    w = (em, None, None)
    return pctx.local_call(
        layer, (x, params["w_router"], params["w_gate"], params["w_up"],
                params["w_down"]), (rows, (), w, w, w), rows,
        partial=(em,) if em else ())


def moe_forward(params, x: torch.Tensor, moe, activation: str = "swiglu",
                dispatch: Optional[str] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  The load-balance loss is apart, in
    ``moe_aux_loss``.  `dispatch`: "einsum", "sort", "gshard:G" or
    "sortg:G" (``moe.dispatch`` when None)."""
    B, S, d = x.shape
    N = B * S
    method = dispatch or moe.dispatch
    if pctx.is_dtensor(x):
        # "einsum" and "sort" as one group of all N tokens: the same
        # routing, capacity and arrival order, in the grouped form
        method = {"einsum": "gshard:1", "sort": "sortg:1"}.get(method,
                                                                method)
        groups = int(method.split(":")[1]) if ":" in method else 1
        out = _moe_shards(params, x, moe, activation, method, groups)
        if "shared" in params:
            out = out + mlp(params["shared"], x, activation)
        return out
    x2d = x.reshape(N, d)

    if method.startswith(("gshard", "sortg")):
        groups = int(method.split(":")[1]) if ":" in method else 1
        if N % groups:
            raise ValueError(f"{N} tokens do not split into {groups} "
                             "groups")
        out = _grouped(params, x2d, moe, activation, N // groups,
                       method.startswith("sortg"))
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
    """GShard load-balance auxiliary loss (mean gate * mean assignment).
    On DTensors each rank sums its own tokens' gates and first choices
    (``pctx.local_call``) and the sums are added across ranks."""
    d = x.shape[-1]
    if pctx.is_dtensor(x):
        rows = pctx.activation_rows(x.ndim)
        sums = pctx.local_call(
            lambda w_r, x: _aux_sums(w_r, x.reshape(-1, d), moe)[None],
            (params["w_router"], x), ((), rows), (rows[0], None, None))
        me, ce = (sums.sum(dim=0) / (x.numel() // d)).unbind(0)
        return moe.n_experts * torch.sum(me * ce)
    _, idx, gates = _router(params, x.reshape(-1, d), moe)
    me = gates.mean(dim=0)
    ce = F.one_hot(idx[:, 0], moe.n_experts).float().mean(dim=0)
    return moe.n_experts * torch.sum(me * ce)


def _aux_sums(w_router, x2d, moe) -> torch.Tensor:
    """(2, E): the gates' sum and the first choices' counts over x2d."""
    _, idx, gates = _router({"w_router": w_router}, x2d, moe)
    ce = F.one_hot(idx[:, 0], moe.n_experts).float()
    return torch.stack([gates.sum(dim=0), ce.sum(dim=0)])
