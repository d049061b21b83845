"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

Each function here computes what its hand-written kernel computes, with
the same arithmetic in the same order, on tensors of any device.  The
kernel wrappers fall back to them only for tensors that lie on the CPU;
on the card they are the yardstick the kernels are checked against.

``flash_attention_ref`` and ``rglru_scan_ref`` repeat the reference's
oracles: full materialised softmax attention, and the serial recurrence
h_t = a_t h_{t-1} + b_t one step at a time (a multiply, then an add,
each rounded, as the scan kernel does).  ``ssd_scan_ref`` is the SSD
scan in its chunked state-passing form, as the tensor-core kernel
computes it (the reference's oracle steps token by token, which is the
same function).  ``flash_attention_bwd_ref``, ``rglru_scan_bwd_ref`` and
``ssd_scan_bwd_ref`` are their gradients written out as formulas (the
reference has no backward kernel: XLA differentiates its jnp paths), the
yardsticks of the backward kernels; ``flash_attention_lse_ref`` is the
row log-sum-exp the tensor-core forward kernels write for their
backwards.  ``tf32_split`` is the operand split of the f32 attention
kernels' 3xTF32 products, ``bf16_split`` the hi + lo split of an f32
value the bf16 tensor-core kernels feed their products.

The forest layout is the complete-tree one of ``core.predictor``:

    feat (T, 2^D - 1) int32   split feature per internal node
    thr  (T, 2^D - 1) f32     split threshold
    leaf (T, 2^D)     f32     leaf values

The tree-mean sums the T leaf values in numpy's pairwise order
(``np.add.reduce`` over a contiguous row: eight interleaved partial sums
per block of at most 128 values, halved recursively above that), so a
prediction is bitwise the one ``RandomForestRegressor._predict_numpy``
makes.  A capacity table compares predictions against QoS bounds, and a
different summation order can move a prediction that sits on its bound
by one ulp to the other side.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

#: numpy's pairwise-summation block (``PW_BLOCKSIZE``)
PW_BLOCK = 128

#: the reference's finite mask value (bf16-safe large negative)
NEG_INF = -2.3819763e38


def attention_mask(S: int, causal: bool, kind: str, window: int,
                   device) -> torch.Tensor:
    """(S, S) bool: which key each query may attend to."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    valid = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        valid &= qp >= kp
    if kind == "local":
        valid &= (qp - kp) < window
    elif kind == "chunked":
        valid &= torch.div(qp, window, rounding_mode="floor") == \
            torch.div(kp, window, rounding_mode="floor")
    return valid


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, kind: str = "global",
                        window: int = 0, softcap: float = 0.0
                        ) -> torch.Tensor:
    """q, k: (BH, S, D); v: (BH, S, Dv) (Dv may differ from D). Full
    materialised softmax attention in f32, scaled by 1/sqrt(D); the
    output (BH, S, Dv) in q's dtype."""
    BH, S, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = attention_mask(S, causal, kind, window, q.device)
    s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, kind: str = "global",
                            window: int = 0, softcap: float = 0.0
                            ) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled (and softcapped)
    masked scores, natural log, in f32: q (BH, S, D), k (BH / G, S, D),
    query row bh reading kv row bh // G -> (BH, S).  What the
    tensor-core forward kernels (bf16 and f32) write for the backward when
    a gradient will be taken."""
    BH, S, D = q.shape
    kr = k.float().repeat_interleave(BH // k.shape[0], dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr) / math.sqrt(D)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = attention_mask(S, causal, kind, window, q.device)
    s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
    return torch.logsumexp(s, dim=-1)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serial recurrence h_t = a_t h_{t-1} + b_t.  a, b: (B, S, W) f32;
    h0: (B, W) f32 or None.  Returns h (B, S, W)."""
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty_like(a)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            kind: str = "global", window: int = 0,
                            softcap: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Gradients of ``flash_attention_ref`` in f32, written out.  q:
    (BH, S, D); o, do: (BH, S, Dv); k: (BH / G, S, D), v: (BH / G, S, Dv),
    query row bh reading kv row bh // G.
    With s the scaled (and softcapped, t = tanh(s / c)) masked scores,
    p = softmax(s) and D_i = rowsum(dO * O):

        dv = p^T dO              dp = dO v^T
        ds = p (dp - D_i) (1 - t^2 with a softcap)
        dq = ds k / sqrt(D)      dk = ds^T q / sqrt(D)

    dk and dv summed over each kv row's G query rows.  Returns (dq, dk,
    dv) in the inputs' dtype."""
    BH, S, D = q.shape
    group = BH // k.shape[0]
    kr = k.float().repeat_interleave(group, dim=0)
    vr = v.float().repeat_interleave(group, dim=0)
    qf, dof = q.float(), do.float()
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", qf, kr) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    valid = attention_mask(S, causal, kind, window, q.device)
    s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vr)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bqk,bkd->bqd", ds, kr) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    if group > 1:
        dk = dk.reshape(-1, group, S, D).sum(dim=1)
        dv = dv.reshape(-1, group, S, v.shape[-1]).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of ``rglru_scan_ref`` as a serial reverse scan: with h its
    output and dh the gradient of the loss by h, in reverse time order

        g_t = dh_t + a_{t+1} g_{t+1}   (g past the end 0, a past it 0)
        db_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0 or zeros)
        dh0 = a_0 g_0

    each step a multiply and then an add, each rounded, as the backward
    kernel does.  a, h, dh: (B, S, W) f32.  Returns (da, db, dh0)."""
    B, S, W = a.shape
    zeros = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    g = zeros
    a_next = zeros
    for t in range(S - 1, -1, -1):
        g = dh[:, t] + a_next * g
        db[:, t] = g
        if t > 0:
            h_prev = h[:, t - 1]
        else:
            h_prev = zeros if h0 is None else h0.float()
        da[:, t] = g * h_prev
        a_next = a[:, t]
    return da, db, a_next * g


def ssd_scan_ref(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, chunk: int = 256,
                 split: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan in the state-passing form, in f32.

    x (B, H, S, P); dA, dt (B, H, S) f32; Bm, Cm (B, G, S, N) with G
    dividing H (head h reads group h // (H / G)); h0 (B, H, P, N) f32 or
    None (zeros).  The sequence is cut into chunks of `chunk` rows, the
    last one zero-padded (dA = 0 keeps cum at its last row, dt = 0 gives
    the padding no weight).  With cum the within-chunk cumulative sum of
    dA, as the tensor-core kernel computes it:

        w = exp(cum_last - cum) * dt,  dS_c = x^T (B * w)   every chunk
        h_c = exp(cum_last) h_{c-1} + dS_c,  h_{-1} = h0     the pass
        y = ((C B^T) * L * dt) x + exp(cum) * (C h_{c-1}^T)  every chunk
            L[i, j] = exp(cum_i - cum_j) for i >= j, else 0

    With ``split="tf32"`` each of the four products is formed as the f32
    tensor-core kernel (``csrc/ssd_scan_tf32.cu``) forms it, ``tf32_mm``
    on the operands it feeds the tensor cores (x w, B, C, the f32 states,
    M, x); the pass and everything else stay f32.  Returns (y in x's
    dtype, final state (B, H, P, N) f32; f64 for f64 inputs)."""
    mm = _products(split)
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    rep = H // Bm.shape[1]
    if rep > 1:
        Bm = Bm.repeat_interleave(rep, dim=1)
        Cm = Cm.repeat_interleave(rep, dim=1)
    ft = torch.promote_types(x.dtype, torch.float32)
    h = (torch.zeros((B, H, P, N), dtype=ft, device=x.device)
         if h0 is None else h0.to(ft))
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(a: torch.Tensor) -> torch.Tensor:
        """(B, H, S, ...) -> (B, H, nc, chunk, ...) in f32 (f64 for f64
        inputs), zero-padded."""
        a = a.to(ft)
        if pad:
            a = torch.cat([a, a.new_zeros((B, H, pad) + a.shape[3:])], dim=2)
        return a.reshape((B, H, nc, chunk) + a.shape[3:])

    xc, Bc, Cc = chunks(x), chunks(Bm), chunks(Cm)
    dtc = chunks(dt)
    cum = torch.cumsum(chunks(dA), dim=-1)                    # (B,H,nc,c)
    last = cum[..., -1:]
    w = torch.exp(last - cum) * dtc
    if split is None:
        dS = xc.transpose(-1, -2) @ (Bc * w[..., None])       # (B,H,nc,P,N)
    else:   # the kernel's A operand is (x w)^T
        dS = mm((xc * w[..., None]).transpose(-1, -2), Bc)
    decay = torch.exp(last)[..., None]                        # (B,H,nc,1,1)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, :, c] * h + dS[:, :, c]
    h_in = torch.stack(h_in, dim=2)                           # (B,H,nc,P,N)
    seg = cum[..., :, None] - cum[..., None, :]
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()
    # exp only where i >= j: above the diagonal seg > 0 may overflow
    L = torch.exp(seg.masked_fill(~lower, float("-inf")))
    M = mm(Cc, Bc.transpose(-1, -2)) * L * dtc[..., None, :]
    y = mm(M, xc) + torch.exp(cum)[..., None] * mm(Cc, h_in.transpose(-1, -2))
    y = y.reshape(B, H, nc * chunk, P)[:, :, :S]
    return y.to(x.dtype), h


def ssd_scan_bwd_ref(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor,
                     h0: Optional[torch.Tensor], dy: torch.Tensor,
                     dh: Optional[torch.Tensor] = None, chunk: int = 64,
                     split=False) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``ssd_scan_ref`` written out in its state-passing
    form, in f32, as the backward kernels compute them.  dy (B, H, S, P)
    is the loss's gradient by y, dh (B, H, P, N) f32 by the final state
    (None: zeros).  Per chunk, with cum the within-chunk cumulative sum
    of dA, L its last row, h_in the state entering the chunk and g the
    gradient by the state leaving it:

        g_{c-1} = e^{cum_L} g_c + sum_i e^{cum_i} dy_i C_i^T,  dh0 = g_{-1}
        W_ij = (C_i . B_j) e^{cum_i - cum_j} dt_j   (i >= j, else 0)
        R_ij = (dy_i . x_j) e^{cum_i - cum_j} dt_j
        w_j = e^{cum_L - cum_j} dt_j,  gB_j = g B_j,  u_j = x_j . gB_j
        dx_j = sum_i W_ij dy_i + w_j gB_j
        dC_i = sum_j R_ij B_j + e^{cum_i} h_in^T dy_i
        dB_j = sum_i R_ij C_i + w_j g^T x_j
        ddt_j = sum_i (dy_i . x_j)(C_i . B_j) e^{cum_i - cum_j}
                + e^{cum_L - cum_j} u_j
        dcum_i = sum_{j<i} Q_ij - sum_{k>i} Q_ki + e^{cum_i} C_i . (h_in^T
                 dy_i) - w_i u_i,  Q_ij = (dy_i . x_j)(C_i . B_j) e^{..} dt_j
                 (Q's diagonal, which would enter twice with opposite
                 signs, left out of both sums),
        dcum_L += sum_j w_j u_j + e^{cum_L} <g, h_in>
        ddA_k = sum_{i >= k} dcum_i   within the chunk

    dB and dC are summed over the heads of each group.  With `split`
    True (or "bf16"), the values the bf16 tensor-core kernel
    (``csrc/ssd_scan_bwd_wgmma.cu``) feeds its products as bf16 hi + lo
    (``bf16_split``) are rounded so: x w and dy e^{cum} in the walks'
    state terms, the stored states h_in and g (also in <g, h_in>), and W
    and R; the walks' running states and everything else stay f32.  With
    ``split="tf32"`` every product is formed as the f32 tensor-core kernel
    (``csrc/ssd_scan_bwd_tf32.cu``) forms it, ``tf32_mm`` on the operands
    it feeds the tensor cores; the states stay f32, u and v are the row
    dots of B with x g and of C with dy h_in, and R B and R^T C are one
    product for each tile of TF32_HEAD_TILE heads of a group, with R
    summed over the tile's heads, as the kernel takes them.  Returns (dx in x's dtype, ddA, ddt f32, dB, dC in Bm's dtype,
    dh0 f32; f64 for f64 inputs)."""
    mode = "bf16" if split is True else (split or None)
    if mode not in (None, "bf16", "tf32"):
        raise ValueError(f"split {split!r}: False, True, 'bf16' or 'tf32'")
    mm = _products("tf32" if mode == "tf32" else None)
    Bsz, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    rep = H // G
    if rep > 1:
        Bm = Bm.repeat_interleave(rep, dim=1)
        Cm = Cm.repeat_interleave(rep, dim=1)
    nc = -(-S // chunk)
    pad = nc * chunk - S

    ft = torch.promote_types(x.dtype, torch.float32)

    def chunks(a: torch.Tensor) -> torch.Tensor:
        """(B, H, S, ...) -> (B, H, nc, chunk, ...) in f32 (f64 for f64
        inputs), zero-padded."""
        a = a.to(ft)
        if pad:
            a = torch.cat([a, a.new_zeros((Bsz, H, pad) + a.shape[3:])],
                          dim=2)
        return a.reshape((Bsz, H, nc, chunk) + a.shape[3:])

    def rnd(a: torch.Tensor) -> torch.Tensor:
        """`a` as the bf16 tensor-core kernel's operand: hi + lo with
        `split` "bf16"."""
        if mode != "bf16":
            return a
        hi, lo = bf16_split(a)
        return hi + lo

    xc, Bc, Cc, dyc = chunks(x), chunks(Bm), chunks(Cm), chunks(dy)
    dtc = chunks(dt)
    cum = torch.cumsum(chunks(dA), dim=-1)                    # (B,H,nc,c)
    last = cum[..., -1:]
    w = torch.exp(last - cum) * dtc
    ecum = torch.exp(cum)
    decay = torch.exp(last)[..., None]                        # (B,H,nc,1,1)
    dS = mm(rnd(xc * w[..., None]).transpose(-1, -2), Bc)    # (B,H,nc,P,N)
    dG = mm(rnd(dyc * ecum[..., None]).transpose(-1, -2), Cc)  # (B,H,nc,P,N)
    zeros = torch.zeros((Bsz, H, P, N), dtype=ft, device=x.device)
    h = zeros if h0 is None else h0.to(ft)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, :, c] * h + dS[:, :, c]
    h_in = rnd(torch.stack(h_in, dim=2))
    g = zeros if dh is None else dh.to(ft)
    g_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        g_out[c] = g
        g = decay[:, :, c] * g + dG[:, :, c]
    g_out = rnd(torch.stack(g_out, dim=2))
    seg = cum[..., :, None] - cum[..., None, :]
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()
    # exp only where i >= j: above the diagonal seg > 0 may overflow
    Lm = torch.exp(seg.masked_fill(~lower, float("-inf")))
    CB = mm(Cc, Bc.transpose(-1, -2))
    DX = mm(dyc, xc.transpose(-1, -2))
    M = CB * Lm * dtc[..., None, :]
    R = DX * Lm * dtc[..., None, :]
    Gm = CB * DX * Lm
    gB = mm(Bc, g_out.transpose(-1, -2))                      # (..., c, P)
    hTdy = mm(dyc, h_in)                                      # (..., c, N)
    gTx = mm(xc, g_out)                                       # (..., c, N)
    dx = mm(rnd(M).transpose(-1, -2), dyc) + w[..., None] * gB
    if mode == "tf32":
        # the f32 kernel sums R over each tile of up to TF32_HEAD_TILE of
        # a group's heads, which share B and C, and takes one product a
        # tile; the tile's sum lands on its first head
        RB, RC = torch.zeros_like(hTdy), torch.zeros_like(gTx)
        for h0_ in range(0, H, rep):
            for t0 in range(h0_, h0_ + rep, TF32_HEAD_TILE):
                t1 = min(t0 + TF32_HEAD_TILE, h0_ + rep)
                Rt = R[:, t0:t1].sum(1)
                RB[:, t0] = mm(Rt, Bc[:, t0])
                RC[:, t0] = mm(Rt.transpose(-1, -2), Cc[:, t0])
        dC = RB + ecum[..., None] * hTdy
        dB = RC + w[..., None] * gTx
    else:
        dC = mm(rnd(R), Bc) + ecum[..., None] * hTdy
        dB = mm(rnd(R).transpose(-1, -2), Cc) + w[..., None] * gTx
    u = (Bc * gTx).sum(-1) if mode == "tf32" else (xc * gB).sum(-1)
    v = (Cc * hTdy).sum(-1)
    ddt = Gm.sum(-2) + torch.exp(last - cum) * u
    Q = (Gm * dtc[..., None, :]).tril(-1)
    dcum = Q.sum(-1) - Q.sum(-2) + ecum * v - w * u
    dcum[..., -1] += ((w * u).sum(-1)
                      + torch.exp(last[..., 0]) * (g_out * h_in).sum((-1, -2)))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))

    def rows(a: torch.Tensor) -> torch.Tensor:
        """(B, H, nc, chunk, ...) -> (B, H, S, ...)."""
        return a.reshape((Bsz, H, nc * chunk) + a.shape[4:])[:, :, :S]

    dB, dC = rows(dB), rows(dC)
    if rep > 1:
        dB = dB.reshape(Bsz, G, rep, S, N).sum(2)
        dC = dC.reshape(Bsz, G, rep, S, N).sum(2)
    return (rows(dx).to(x.dtype), rows(ddA), rows(ddt), dB.to(Bm.dtype),
            dC.to(Cm.dtype), g)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does; finite inputs."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x as hi = tf32(x) and lo = x - hi, exactly (hi + lo == x).  The
    f32 tensor-core kernel feeds hi and tf32(lo) to the tensor core and
    sums lo_a hi_b + hi_a lo_b + hi_a hi_b (3xTF32)."""
    hi = tf32_round(x)
    return hi, x.float() - hi


#: heads a block of the f32 SSD backward kernel takes, sharing B and C
TF32_HEAD_TILE = 4


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32, batched) as the 3xTF32 kernels form it: each operand
    split into hi = tf32(x) and lo = tf32(x - hi), the product
    lo_a hi_b + hi_a lo_b + hi_a hi_b summed in f32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return tf32_round(al) @ bh + ah @ tf32_round(bl) + ah @ bh


def _products(split: Optional[str]):
    """The matrix product of an SSD plain version: ``tf32_mm`` for
    split "tf32", else the plain one."""
    if split is None:
        return torch.matmul
    if split != "tf32":
        raise ValueError(f"split {split!r}: None or 'tf32'")
    return tf32_mm


def bf16_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x as hi = bf16(x) and lo = bf16(x - hi), both returned in x's
    float type: the two bf16 parts the tensor-core kernels feed their
    products for an f32 value (``split2`` in ``csrc/hopper_wgmma.cuh``,
    round to nearest even).  hi + lo carries about 16 bits of x."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def forest_depth(feat: torch.Tensor) -> int:
    """Depth D of a complete-tree forest with (T, 2^D - 1) split nodes."""
    nn = feat.shape[1]
    depth = (nn + 1).bit_length() - 1
    if (1 << depth) - 1 != nn:
        raise ValueError(f"complete tree layout required: {nn} internal "
                         "nodes is not 2^D - 1")
    return depth


def pairwise_sum(vals: torch.Tensor, lo: int = 0, n: int = -1
                 ) -> torch.Tensor:
    """Row sums of ``vals[:, lo:lo + n]`` (f32) in numpy's pairwise
    order; n = -1 sums to the last column."""
    if n < 0:
        n = vals.shape[1] - lo
    if n < 8:
        res = torch.zeros(vals.shape[0], dtype=vals.dtype,
                          device=vals.device)
        for i in range(lo, lo + n):
            res = res + vals[:, i]
        return res
    if n <= PW_BLOCK:
        r = vals[:, lo:lo + 8]
        i = 8
        while i < n - n % 8:
            r = r + vals[:, lo + i:lo + i + 8]
            i += 8
        res = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3]))
               + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
        for j in range(lo + i, lo + n):
            res = res + vals[:, j]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(vals, lo, n2) + pairwise_sum(vals, lo + n2, n - n2)


def rfr_forest_ref(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                   leaf: torch.Tensor) -> torch.Tensor:
    """Level-synchronous forest descent: x (N, F) f32 -> tree-mean
    predictions (N,) f32."""
    depth = forest_depth(feat)
    n = x.shape[0]
    t, nn = feat.shape
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=x.device)
    t_ids = torch.arange(t, device=x.device)[None, :]          # (1, T)
    rows = torch.arange(n, device=x.device)[:, None]           # (N, 1)
    idx = torch.zeros((n, t), dtype=torch.long, device=x.device)
    for _ in range(depth):
        f = feat[t_ids, idx].long()
        go_right = x[rows, f] >= thr[t_ids, idx]
        idx = 2 * idx + 1 + go_right.long()
    vals = leaf[t_ids, idx - nn]                               # (N, T)
    total = pairwise_sum(vals)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as
    # a multiply by its reciprocal, which is not IEEE division for T = 24
    return total / torch.full_like(total, t)


def rfr_capacity_sweep_ref(x: torch.Tensor, bounds: torch.Tensor,
                           feat: torch.Tensor, thr: torch.Tensor,
                           leaf: torch.Tensor,
                           log_target: bool = False) -> torch.Tensor:
    """The fused capacity m-sweep: x (S, M, R, F) rows, bounds (S, M, R)
    (+inf = padded row, passes; -inf = m past the scenario's m_max,
    fails).  A concurrency m passes when all R of its rows predict at or
    under their bound; the capacity is the longest passing prefix of m.
    Returns (S,) int32."""
    s, m, r, f = x.shape
    if s == 0 or m == 0 or r == 0:
        return torch.zeros(s, dtype=torch.int32, device=x.device)
    preds = rfr_forest_ref(x.reshape(s * m * r, f), feat, thr, leaf)
    if log_target:
        preds = torch.exp(preds)
    m_ok = (preds.reshape(s, m, r) <= bounds).all(dim=2)        # (S, M)
    fails = torch.cumsum((~m_ok).to(torch.int32), dim=1)
    return (fails == 0).sum(dim=1).to(torch.int32)
