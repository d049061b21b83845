"""Public entry points of the forest kernels, with the engine dispatch of
``repro.kernels.ops``: ``use_kernel=True`` goes through the hand-written
kernel's wrapper (which takes the plain version itself for tensors on
the CPU), ``use_kernel=False`` through the plain PyTorch version on the
tensors' own device."""
from __future__ import annotations

import torch

from . import ref
from .rfr_inference import rfr_capacity_sweep, rfr_forest_apply


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
