"""Flash attention forward: the wrapper around the Hopper kernel in
``csrc/flash_attention.cu``.

Layout: q (BH, S, D); k and v (BH / G, S, D) — batch and heads merged
with heads inner, so query row ``bh`` attends with kv row ``bh // G``
(MQA and GQA without a repeat of k and v).  f32 or bf16, D up to 256;
the output is in q's dtype.  Masks: causal, ``local`` (keys within
``window`` of the query) and ``chunked`` (aligned chunks of ``window``),
with an optional tanh softcap on the scores.

Given CUDA tensors the wrapper launches the kernel on PyTorch's current
stream and adds one to ``flash_attention.launches``; a launch the runtime
refuses raises.  Given CPU tensors it computes the same function with the
plain version (``ref.flash_attention_ref``, after repeating k and v) and
launches nothing.
"""
from __future__ import annotations

import torch

from . import _build, ref

KINDS = {"global": 0, "local": 1, "chunked": 2}
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
           window: int) -> int:
    """Validate the inputs; returns the group size G."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, D): {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, D = q.shape
    if k.shape != v.shape or k.shape[1:] != q.shape[1:]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[0] == 0 or BH % k.shape[0]:
        raise ValueError(f"{BH} query rows do not group over {k.shape[0]} "
                         "kv rows")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q is on {q.device}: the port runs on the CPU or a "
                         "CUDA device")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} above {MAX_HEAD_DIM}")
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    if kind != "global" and window < 1:
        raise ValueError(f"{kind} attention needs window >= 1, got {window}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return BH // k.shape[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kind: str = "global",
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q (BH, S, D), k and v (BH / G, S, D) -> (BH, S, D) in q's dtype."""
    group = _check(q, k, v, kind, window)
    if q.device.type == "cpu":
        if group > 1:
            k = k.repeat_interleave(group, dim=0)
            v = v.repeat_interleave(group, dim=0)
        return ref.flash_attention_ref(q, k, v, causal=causal, kind=kind,
                                       window=window, softcap=softcap)
    BH, S, D = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S,
            D, group, int(q.dtype == torch.bfloat16), int(causal),
            KINDS[kind], int(window), float(softcap), stream)
    _build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
