"""RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t: the wrapper around
the two Hopper kernels in ``csrc/rglru_scan.cu``, the TMA-fed
channel-tiled scan (``path`` "tma": W a multiple of 4, which the tensor
map's 16-byte row stride needs) and the one-thread-per-channel scan
("simt": every other W).  Both compute each step as a multiply and then
an add, each rounded, in time order: bitwise the plain version.

a, b: (B, S, W) f32; h0: (B, W) f32 or None (zeros).  Returns h
(B, S, W) f32.  Given CUDA tensors the wrapper launches the kernel of
its path on PyTorch's current stream and adds one to
``rglru_scan.launches`` and to ``rglru_scan.launches_by_path[path]``; a
build or launch that fails raises, and nothing falls back to the other
kernel.  Given CPU tensors it computes the same function with the plain
version (``ref.rglru_scan_ref``) and launches nothing.

The gradient: ``rglru_scan_bwd`` wraps the same source's backward
kernels, the two paths run in reverse time (bitwise
``ref.rglru_scan_bwd_ref``), adding one to ``rglru_scan_bwd.launches`` and to
``rglru_scan_bwd.launches_by_path[path]``; on CPU tensors it is the plain
version.  ``RGLRUScanFn`` is the ``torch.autograd.Function`` that pairs
the forward kernel with it; ``rglru_scan_fn`` applies it.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref


def path(batch: int, s: int, w: int) -> str:
    """The kernel that scans (batch, s, w) on the card: "tma" where w is
    a multiple of 4 and no extent is 0, else "simt"."""
    if batch >= 1 and s >= 1 and w >= 1 and w % 4 == 0:
        return "tma"
    return "simt"


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
    kernel = path(B, S, W)
    lib = _build.load("rglru_scan")
    h0_ptr = None if h0 is None else h0.data_ptr()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if kernel == "tma":
            # the tensor maps need 16-byte aligned bases
            for name, t in (("a", a), ("b", b)):
                if t.data_ptr() % 16:
                    raise ValueError(f"{name} is not 16-byte aligned")
            err = lib.rglru_scan_tma_fwd(a.data_ptr(), b.data_ptr(), h0_ptr,
                                         out.data_ptr(), B, S, W, stream)
        else:
            err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h0_ptr,
                                     out.data_ptr(), B, S, W, stream)
    _build.check_launch(err, f"rglru_scan ({kernel})")
    rglru_scan.launches += 1
    rglru_scan.launches_by_path[kernel] += 1
    return out


rglru_scan.launches = 0
rglru_scan.launches_by_path = {"tma": 0, "simt": 0}


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, with_dh0: bool = False):
    """Gradients of ``rglru_scan``: a, h (its output), dh (the loss's
    gradient by h): (B, S, W) f32; h0: (B, W) f32 or None.  Returns (da,
    db, dh0), dh0 None unless `with_dh0`."""
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got {tuple(a.shape)}")
    B, S, W = a.shape
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a is on {a.device}: the port runs on the CPU or a "
                         "CUDA device")
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        _check(name, t, (B, S, W), a.device)
    if h0 is not None:
        _check("h0", h0, (B, W), a.device)
    if a.device.type == "cpu":
        da, db, dh0 = ref.rglru_scan_bwd_ref(a, h, dh, h0)
        return da, db, dh0 if with_dh0 else None
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = (torch.empty((B, W), dtype=torch.float32, device=a.device)
           if with_dh0 else None)
    if a.numel() == 0:
        if dh0 is not None:
            dh0.zero_()
        return da, db, dh0
    kernel = path(B, S, W)
    lib = _build.load("rglru_scan")
    args = (a.data_ptr(), h.data_ptr(), dh.data_ptr(),
            None if h0 is None else h0.data_ptr(), da.data_ptr(),
            db.data_ptr(), None if dh0 is None else dh0.data_ptr(), B, S, W)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if kernel == "tma":
            for name, t in (("a", a), ("h", h), ("dh", dh)):
                if t.data_ptr() % 16:
                    raise ValueError(f"{name} is not 16-byte aligned")
            err = lib.rglru_scan_tma_bwd(*args, stream)
        else:
            err = lib.rglru_scan_bwd(*args, stream)
    _build.check_launch(err, f"rglru_scan_bwd ({kernel})")
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.launches_by_path[kernel] += 1
    return da, db, dh0


rglru_scan_bwd.launches = 0
rglru_scan_bwd.launches_by_path = {"tma": 0, "simt": 0}


class RGLRUScanFn(torch.autograd.Function):
    """``rglru_scan`` with its hand-written gradient: the forward kernel,
    then ``rglru_scan_bwd`` on the saved a, h0 and output h."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(a, h, dh.contiguous(), h0,
                                     with_dh0=ctx.needs_input_grad[2])
        return da, db, dh0


def rglru_scan_fn(a: torch.Tensor, b: torch.Tensor,
                  h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rglru_scan`` that autograd differentiates with the backward kernel
    (its plain version on CPU tensors)."""
    return RGLRUScanFn.apply(a, b, h0)


def reset_launches():
    """Zero the launch counts, the total and each path's, and the
    backward's."""
    rglru_scan.launches = 0
    for key in rglru_scan.launches_by_path:
        rglru_scan.launches_by_path[key] = 0
    rglru_scan_bwd.launches = 0
    for key in rglru_scan_bwd.launches_by_path:
        rglru_scan_bwd.launches_by_path[key] = 0
