"""Flash attention forward: the wrapper around the three Hopper kernels,
``csrc/flash_attention_wgmma.cu`` (bf16 with head dim 64, 80, 128 or
256, or MLA's q/k 192 and v 128, on the tensor cores),
``csrc/flash_attention_tf32.cu`` (f32 with head dim 64, 96, 128 or 256,
or MLA's, softcap or not, on the tensor cores in 3xTF32) and
``csrc/flash_attention.cu`` (every other case, on the CUDA cores in
f32).  ``path(dtype, D, softcap, v_dim)`` names the one that runs; the
choice depends on the dtype and the head dims of q and k (D) and of v
(Dv) alone.

Layout: q and k (BH, S, D) and (BH / G, S, D); v (BH / G, S, Dv) —
batch and heads merged with heads inner, so query row ``bh`` attends with
kv row ``bh // G`` (MQA and GQA without a repeat of k and v).  f32 or
bf16, D and Dv up to 256; the output (BH, S, Dv) is in q's dtype, the
scale 1/sqrt(D).  Dv differs from D in MLA (deepseek-v2: D 192, Dv 128),
which both tensor-core kernels take at that pair and the CUDA-core
kernel at any.  Masks: causal, ``local``
(keys within ``window`` of the query) and ``chunked`` (aligned chunks of
``window``), with an optional tanh softcap on the scores.

Given CUDA tensors the wrapper launches the kernel of its path on
PyTorch's current stream and adds one to ``flash_attention.launches`` and
to ``flash_attention.launches_by_path[path]``; a build or launch that
fails raises, and nothing falls back to the other kernel.  Given CPU
tensors it computes the same function with the plain version
(``ref.flash_attention_ref``, after repeating k and v) and launches
nothing.  With ``return_lse`` it also returns each row's log-sum-exp
(BH, S) f32, which the two tensor-core kernels write beside o (the plain
``ref.flash_attention_lse_ref`` on the CPU).  Both tensor-core forwards
may cut each q tile's kv range into shares, one block each, joined in
order by a second launch: the count is the kernel's own plan for the
shape (``flash_attention_<kernel>_splits``, kept per shape), the
partials go to scratch of ``fwd_scratch_bytes``.

The backward, ``flash_attention_bwd``, has three kernels:
``csrc/flash_attention_bwd_wgmma.cu`` (bf16 at D = Dv in
WGMMA_BF16_HEAD_DIMS and at (D, Dv) in WGMMA_QK_V_DIMS, on the tensor
cores),
``csrc/flash_attention_bwd_tf32.cu`` (f32 at TF32_HEAD_DIMS and
WGMMA_QK_V_DIMS, softcap or not, on the tensor cores in 3xTF32), both
reading the forward's lse, and ``csrc/flash_attention_bwd.cu`` (every
other case, any Dv, on the CUDA cores in f32, recomputing the lse);
``bwd_path(dtype, D, softcap, v_dim)`` names the one that runs, and
``flash_attention_bwd.launches_by_path`` counts each.
``FlashAttentionFn`` asks the forward for the lse when a gradient will
be taken on a path that reads it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build, _scratch, ref

KINDS = {"global": 0, "local": 1, "chunked": 2}
MAX_HEAD_DIM = 256
#: head dims of the bf16 (wgmma) path: whole 64-column (128-byte) blocks
#: up to the 256 columns one wgmma accumulator holds, and hubert-xlarge's
#: 80, stored as two whole blocks that the tensor maps' out-of-bounds
#: fill pads with zeros
WGMMA_BF16_HEAD_DIMS = (64, 80, 128, 256)
#: head dims of the f32 (3xTF32 mma.sync) path: 64, 128, 256 and the
#: ~100M training example's 96 (12 k8 steps at its true width); the
#: mma.sync fragments take any multiple of 8, but 80 and the smoke
#: configs' 16 and 32 stay on the CUDA-core kernels until a model needs
#: them
TF32_HEAD_DIMS = (64, 96, 128, 256)
#: (D, Dv) pairs with v narrower than q and k that both tensor-core
#: kernels also take: MLA's 128 + 64 query / key columns and 128 value
#: columns
WGMMA_QK_V_DIMS = ((192, 128),)


def path(dtype: torch.dtype, head_dim: int, softcap: float = 0.0,
         v_dim: Optional[int] = None) -> str:
    """The kernel that computes attention of `dtype` with q and k of head
    dim `head_dim` and v of head dim `v_dim` (`head_dim` when None) on
    the card: "wgmma" for bf16 at D = Dv in WGMMA_BF16_HEAD_DIMS or (D,
    Dv) in WGMMA_QK_V_DIMS; "tf32" for f32 at D = Dv in TF32_HEAD_DIMS or
    (D, Dv) in WGMMA_QK_V_DIMS; "simt" otherwise (any other head dims).
    No path depends on the softcap; every caller names it all the same,
    as the whole case the kernel computes.

    With a softcap the 3xTF32 kernel runs q.k on the FP64 tensor cores
    and forms each score in double (its source says why): at softcapped
    scores (tens in magnitude) one f32
    rounding of a score moves the output by about the f32 tolerance, so
    that kernel is held against the function evaluated in float64, within
    the f32 tolerance, where the plain f32 version itself lands at up to
    0.86 of it (chip_smoke phase 4)."""
    if v_dim is None or v_dim == head_dim:
        tensor_cores = head_dim in (WGMMA_BF16_HEAD_DIMS
                                    if dtype == torch.bfloat16
                                    else TF32_HEAD_DIMS)
    else:
        tensor_cores = (head_dim, v_dim) in WGMMA_QK_V_DIMS
    if not tensor_cores:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32"


def bwd_path(dtype: torch.dtype, head_dim: int, softcap: float = 0.0,
             v_dim: Optional[int] = None) -> str:
    """The kernel that computes the attention backward of `dtype` with q
    and k of head dim `head_dim` and v of head dim `v_dim` (`head_dim`
    when None) on the card: "wgmma" (bf16 at D = Dv in
    WGMMA_BF16_HEAD_DIMS or (D, Dv) in WGMMA_QK_V_DIMS) or "tf32" (f32 at
    D = Dv in TF32_HEAD_DIMS or those (D, Dv)), both reading the
    forward's lse, with or without a softcap; "simt" in every other case
    (f32 on the CUDA cores, its own lse).  It is the
    forward's ``path`` in every case: what the forward's kernel
    computes, this one differentiates, and the tensor-core forwards write
    the lse the tensor-core backwards read."""
    return path(dtype, head_dim, softcap, v_dim)


#: the backward paths that read the forward's lse
LSE_BWD_PATHS = ("wgmma", "tf32")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
           window: int) -> int:
    """Validate the inputs; returns the group size G.  It runs before every
    launch, so it reads each shape once and compares ints (slicing a
    torch.Size builds another)."""
    qs, ks, vs = tuple(q.shape), tuple(k.shape), tuple(v.shape)
    if len(qs) != 3 or len(ks) != 3 or len(vs) != 3:
        raise ValueError(f"q, k, v must be (BH, S, D): {qs}, {ks}, {vs}")
    BH, S, D = qs
    if ks[1] != S or ks[2] != D or vs[0] != ks[0] or vs[1] != S:
        raise ValueError(f"k {ks} and v {vs} do not fit q {qs}")
    if ks[0] == 0 or BH % ks[0]:
        raise ValueError(f"{BH} query rows do not group over {ks[0]} "
                         "kv rows")
    dtype, dev = q.dtype, q.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"q, k, v dtypes differ: {dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.device == v.device == dev):
        raise ValueError(f"q, k, v on {dev}, {k.device}, {v.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"q is on {dev}: the port runs on the CPU or a "
                         "CUDA device")
    if max(D, vs[2]) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {D}, {vs[2]} above {MAX_HEAD_DIM}")
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    if kind != "global" and window < 1:
        raise ValueError(f"{kind} attention needs window >= 1, got {window}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return BH // ks[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kind: str = "global",
                    window: int = 0, softcap: float = 0.0,
                    return_lse: bool = False):
    """q (BH, S, D), k (BH / G, S, D) and v (BH / G, S, Dv) -> (BH, S, Dv)
    in q's dtype; with `return_lse`, (out, lse) with lse each row's
    log-sum-exp (BH, S) f32.  On the card the two tensor-core paths write
    the lse (wgmma and tf32): asking for it on the simt path raises."""
    group = _check(q, k, v, kind, window)
    mask = dict(causal=causal, kind=kind, window=window, softcap=softcap)
    if q.device.type == "cpu":
        lse = (ref.flash_attention_lse_ref(q, k, **mask) if return_lse
               else None)
        if group > 1:
            k = k.repeat_interleave(group, dim=0)
            v = v.repeat_interleave(group, dim=0)
        out = ref.flash_attention_ref(q, k, v, **mask)
        return (out, lse) if return_lse else out
    BH, S, D = q.shape
    Dv = v.shape[2]
    kernel = path(q.dtype, D, softcap, Dv)
    if return_lse and kernel == "simt":
        raise ValueError("the simt forward writes no lse: only the wgmma "
                         "and tf32 paths (bf16 at D = Dv in "
                         "WGMMA_BF16_HEAD_DIMS, f32 at D = Dv in "
                         "TF32_HEAD_DIMS, or (D, Dv) in WGMMA_QK_V_DIMS) "
                         "do")
    out = q.new_empty((BH, S, Dv))
    lse = (torch.empty((BH, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    if kernel != "simt":
        # the tensor maps and 16-byte copies need 16-byte aligned bases
        for name, a in (("q", q), ("k", k), ("v", v)):
            if a.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")
    with torch.cuda.device(q.device):
        stream = _scratch.current_stream(q.device)
        if kernel == "wgmma":
            lib = _build.load("flash_attention_wgmma")
            # kv shares of each q tile (the kernel's plan for the grid)
            # and the split q tiles' partials in f32
            splits = _fwd_splits(q.device.index, BH, S, D, Dv, int(causal),
                                 KINDS[kind], int(window))
            part = (_scratch.scratch(q.device, stream,
                                     fwd_scratch_bytes(splits, BH, S, Dv))
                    if splits > 1 else None)
            err = lib.flash_attention_wgmma_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if part is None else part.data_ptr(), BH, S, D, Dv,
                group, int(causal), KINDS[kind], int(window), float(softcap),
                splits, stream)
        elif kernel == "tf32":
            lib = _build.load("flash_attention_tf32")
            # kv shares of each q tile (the kernel's choice from the grid)
            # and their outputs, maxima and sums in f32
            splits = lib.flash_attention_tf32_splits(
                BH, S, D, Dv, int(causal), KINDS[kind], int(window))
            part = (_scratch.scratch(q.device, stream,
                                     fwd_scratch_bytes(splits, BH, S, Dv))
                    if splits > 1 else None)
            err = lib.flash_attention_tf32_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(),
                None if lse is None else lse.data_ptr(), BH, S, D, Dv,
                group, int(causal), KINDS[kind], int(window),
                float(softcap), splits, stream)
        else:
            err = _build.load("flash_attention").flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                S, D, Dv, group, int(q.dtype == torch.bfloat16),
                int(causal), KINDS[kind], int(window), float(softcap),
                stream)
    _build.check_launch(err, f"flash_attention ({kernel})")
    flash_attention.launches += 1
    flash_attention.launches_by_path[kernel] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_path = {"wgmma": 0, "tf32": 0, "simt": 0}


def fwd_scratch_bytes(splits: int, bh: int, s: int, dv: int) -> int:
    """Bytes of the scratch a kv-split forward (wgmma or tf32) takes at
    `splits` shares of each q tile: every share's unnormalised (BH, S, Dv)
    output, then its (BH, S) running maxima and sums, f32; 0 unsplit."""
    return splits * bh * s * (dv + 2) * 4 if splits > 1 else 0


@functools.lru_cache(maxsize=256)
def _fwd_splits(device_index: int, *args: int) -> int:
    """The kv shares the wgmma forward cuts each q tile's kv range into
    for (bh, s, d, dv, causal, kind, window) on the current device (it
    reads the SM count), kept per shape."""
    lib = _build.load("flash_attention_wgmma")
    splits = lib.flash_attention_wgmma_splits(*args)
    if splits <= 0:
        raise RuntimeError(f"flash_attention_wgmma: no split count for {args}")
    return splits


def reset_launches():
    """Zero the launch counts, the total and each path's, and the
    backward's."""
    flash_attention.launches = 0
    for key in flash_attention.launches_by_path:
        flash_attention.launches_by_path[key] = 0
    flash_attention_bwd.launches = 0
    for key in flash_attention_bwd.launches_by_path:
        flash_attention_bwd.launches_by_path[key] = 0


def _check_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, do: torch.Tensor, kind: str, window: int):
    group = _check(q, k, v, kind, window)
    want = q.shape[:2] + v.shape[2:]
    for name, a in (("o", o), ("do", do)):
        if a.shape != want or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} {tuple(a.shape)} {a.dtype} on "
                             f"{a.device} does not match {tuple(want)} "
                             f"{q.dtype} on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return group


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: Optional[torch.Tensor] = None, *,
                        causal: bool = True,
                        kind: str = "global", window: int = 0,
                        softcap: float = 0.0):
    """Gradients of ``flash_attention``: q (BH, S, D), o (its output) and
    do (the loss's gradient by o) (BH, S, Dv); k (BH / G, S, D), v (BH /
    G, S, Dv); lse the forward's row log-sum-exp (BH, S) f32 -> (dq, dk,
    dv) in the inputs' dtype, dk and dv summed over each kv row's G query
    rows.  The wgmma and tf32 paths need lse and raise without it; the
    simt path and the plain version (CPU tensors) compute their own and
    ignore it."""
    group = _check_bwd(q, k, v, o, do, kind, window)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                           kind=kind, window=window,
                                           softcap=softcap)
    BH, S, D = q.shape
    Dv = v.shape[2]
    kernel = bwd_path(q.dtype, D, softcap, Dv)
    if kernel in LSE_BWD_PATHS:
        if lse is None:
            raise ValueError(f"the {kernel} backward reads the forward's "
                             "lse: pass flash_attention(..., "
                             "return_lse=True)'s")
        if (lse.shape != (BH, S) or lse.dtype != torch.float32
                or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} on "
                             f"{lse.device} is not a contiguous ({BH}, {S}) "
                             f"float32 tensor on {q.device}")
        for name, a in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if a.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        stream = _scratch.current_stream(q.device)
        if kernel in LSE_BWD_PATHS:
            name = f"flash_attention_bwd_{kernel}"
            # each key tile's work is split into `shares` blocks, whose
            # f32 dK and dV partials (each at its own width) a last
            # launch sums in order; the scratch holds them, then D_i
            # (BH, S) f32
            # (the tf32 count reads its softcapped kernel's occupancy
            # where the scores are capped)
            capped = (int(softcap > 0),) if kernel == "tf32" else ()
            shares = _bwd_shares(name, q.device.index, BH, S, D, Dv, group,
                                 int(causal), KINDS[kind], int(window),
                                 *capped)
            n_part = shares * (k.numel() + v.numel())
            buf = _scratch.scratch(q.device, stream, (n_part + BH * S) * 4)
            part = buf.data_ptr()
            err = getattr(_build.load(name), name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), part + n_part * 4, part, BH, S, D, Dv, group,
                shares, int(causal), KINDS[kind], int(window),
                float(softcap), stream)
        else:
            # per-row log-sum-exp and D_i = rowsum(dO * O), f32
            stats = torch.empty((2, BH, S), dtype=torch.float32,
                                device=q.device)
            err = _build.load("flash_attention_bwd").flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(), BH, S, D, Dv,
                group, int(q.dtype == torch.bfloat16), int(causal), KINDS[kind],
                int(window), float(softcap), stream)
    _build.check_launch(err, f"flash_attention_bwd ({kernel})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_path[kernel] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_path = {"wgmma": 0, "tf32": 0, "simt": 0}


@functools.lru_cache(maxsize=256)
def _bwd_shares(name: str, device_index: int, *args: int) -> int:
    """The dK/dV share count of backward library `name` (the wgmma or
    tf32 one) for (bh, s, d, dv, group, causal, kind, window), and for
    tf32 whether the scores are softcapped, on the current device (it
    reads the SM count and the kernel's occupancy), kept per shape."""
    shares = getattr(_build.load(name), name + "_shares")(*args)
    if shares <= 0:
        raise RuntimeError(f"{name}: no share count for {args}")
    return shares


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its hand-written gradient: the forward
    kernel, then ``flash_attention_bwd`` on the saved q, k, v, output and,
    on the wgmma and tf32 backward paths, the forward's row log-sum-exp.
    The lse is asked for only when a gradient will be taken, so serving's
    calls write none; under ``torch.utils.checkpoint`` the recomputed
    forward writes it again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kind, window, softcap):
        mask = dict(causal=causal, kind=kind, window=window,
                    softcap=softcap)
        want_lse = (any(ctx.needs_input_grad[:3])
                    and bwd_path(q.dtype, q.shape[-1], softcap, v.shape[-1])
                    in LSE_BWD_PATHS)
        if want_lse:
            o, lse = flash_attention(q, k, v, return_lse=True, **mask)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = flash_attention(q, k, v, **mask)
            ctx.save_for_backward(q, k, v, o)
        ctx.mask = mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, *lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         lse[0] if lse else None,
                                         **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, kind: str = "global",
                       window: int = 0, softcap: float = 0.0
                       ) -> torch.Tensor:
    """``flash_attention`` that autograd differentiates with the backward
    kernel (its plain version on CPU tensors)."""
    return FlashAttentionFn.apply(q, k, v, causal, kind, window,
                                  float(softcap))
