"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``
without the SSD scan, which arrives with its own slice).

Each function here computes what its hand-written kernel computes, with
the same arithmetic in the same order, on tensors of any device.  The
kernel wrappers fall back to them only for tensors that lie on the CPU;
on the card they are the yardstick the kernels are checked against.

``flash_attention_ref`` and ``rglru_scan_ref`` repeat the reference's
oracles: full materialised softmax attention, and the serial recurrence
h_t = a_t h_{t-1} + b_t one step at a time (a multiply, then an add,
each rounded, as the scan kernel does).

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
from typing import Optional

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
    """q, k, v: (BH, S, D). Full materialised softmax attention in f32;
    the output in q's dtype."""
    BH, S, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = attention_mask(S, causal, kind, window, q.device)
    s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


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
