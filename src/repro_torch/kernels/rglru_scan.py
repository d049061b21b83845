"""RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t: the wrapper around
the Hopper kernel in ``csrc/rglru_scan.cu``.

a, b: (B, S, W) f32; h0: (B, W) f32 or None (zeros).  Returns h
(B, S, W) f32.  Given CUDA tensors the wrapper launches the kernel on
PyTorch's current stream and adds one to ``rglru_scan.launches``; a
launch the runtime refuses raises.  Given CPU tensors it computes the
same function with the plain version (``ref.rglru_scan_ref``) and
launches nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, a on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: (B, S, W) f32; h0: (B, W) f32 or None -> h (B, S, W)."""
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got {tuple(a.shape)}")
    B, S, W = a.shape
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a is on {a.device}: the port runs on the CPU or a "
                         "CUDA device")
    _check("a", a, (B, S, W), a.device)
    _check("b", b, (B, S, W), a.device)
    if h0 is not None:
        _check("h0", h0, (B, W), a.device)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _build.load("rglru_scan")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(),
                                 None if h0 is None else h0.data_ptr(),
                                 out.data_ptr(), B, S, W, stream)
    _build.check_launch(err, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
