"""Public entry points of the port's kernels, with the dispatch of
``repro.kernels.ops``: ``use_kernel=True`` goes through the hand-written
kernel's wrapper (which takes the plain version itself for tensors on
the CPU), ``use_kernel=False`` through the plain PyTorch version on the
tensors' own device.  Attention, the RG-LRU scan and the SSD scan go
through their ``torch.autograd.Function``s, so a train step
differentiates them with the hand-written backward kernels; without
gradients they launch what the forward wrappers launch.
``use_kernel=False`` is differentiated by autograd through the plain
versions."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .flash_attention import flash_attention_fn
from .rfr_inference import rfr_capacity_sweep, rfr_forest_apply
from .rglru_scan import rglru_scan_fn
from .ssd_scan import ssd_scan_fn


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, kind: str = "global", window: int = 0,
                 softcap: float = 0.0, use_kernel: bool = True
                 ) -> torch.Tensor:
    """q: (B, S, Hq, D); k: (B, S, Hkv, D); v: (B, S, Hkv, Dv) ->
    (B, S, Hq, Dv).  Dv may differ from D (MLA: D 192, Dv 128).

    The kernel reads kv head h // (Hq / Hkv) itself; the plain version
    repeats k and v to Hq heads first, as the reference does."""
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if not use_kernel and Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    # contiguous: with B = 1 the reshape is a strided view
    qm = q.transpose(1, 2).reshape(B * Hq, S, D).contiguous()
    km = k.transpose(1, 2).reshape(B * k.shape[2], S, D).contiguous()
    vm = v.transpose(1, 2).reshape(B * v.shape[2], S, Dv).contiguous()
    fn = flash_attention_fn if use_kernel else ref.flash_attention_ref
    out = fn(qm, km, vm, causal=causal, kind=kind, window=window,
             softcap=softcap)
    return out.reshape(B, Hq, S, Dv).transpose(1, 2)


def rglru_op(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             use_kernel: bool = True) -> torch.Tensor:
    """a, b: (B, S, W) f32 -> h (B, S, W)."""
    if use_kernel:
        return rglru_scan_fn(a, b, h0)
    return ref.rglru_scan_ref(a, b, h0)


def ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor,
           h0: Optional[torch.Tensor] = None, *, chunk: int = 256,
           use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (B, S, H, P); dt (B, S, H) f32 post-softplus; A (H,)
    f32 negative; Bm, Cm (B, S, G, N) with G dividing H (G = H is the
    reference's repeated layout); h0 (B, H, P, N) f32 or None.  Returns
    (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) f32).

    The kernel reads group h // (H / G) itself and tiles the sequence by
    its own chunk; the plain version takes `chunk` rows at a time."""
    xt = x.transpose(1, 2).contiguous()
    dtt = dt.transpose(1, 2).contiguous()
    dA = dtt * A[None, :, None]
    Bt = Bm.transpose(1, 2).contiguous()
    Ct = Cm.transpose(1, 2).contiguous()
    if use_kernel:
        y, h = ssd_scan_fn(xt, dA, dtt, Bt, Ct, h0)
    else:
        y, h = ref.ssd_scan_ref(xt, dA, dtt, Bt, Ct, h0, chunk=chunk)
    return y.transpose(1, 2), h


def rfr_op(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
           leaf: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """Forest inference: x (N, F) -> (N,) predictions."""
    if use_kernel:
        return rfr_forest_apply(x, feat, thr, leaf)
    return ref.rfr_forest_ref(x, feat, thr, leaf)


def rfr_sweep_op(x: torch.Tensor, bounds: torch.Tensor, feat: torch.Tensor,
                 thr: torch.Tensor, leaf: torch.Tensor, *,
                 use_kernel: bool = True,
                 log_target: bool = False) -> torch.Tensor:
    """Fused capacity m-sweep: the device drain's one pass.

    x (S, M, R, F) padded scenario feature rows; bounds (S, M, R) with
    +inf = padded row (always passes) and -inf = m beyond a scenario's
    m_max (always fails).  Returns (S,) int32 max-admissible m."""
    if use_kernel:
        return rfr_capacity_sweep(x, bounds, feat, thr, leaf,
                                  log_target=log_target)
    return ref.rfr_capacity_sweep_ref(x, bounds, feat, thr, leaf,
                                      log_target=log_target)
