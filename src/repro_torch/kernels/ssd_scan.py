"""Mamba-2 SSD chunked scan: the wrapper around the three Hopper kernels,
``csrc/ssd_scan_wgmma.cu`` (bf16 with head dim 64 and d_state 128, the
served shape, on the tensor cores), ``csrc/ssd_scan_tf32.cu`` (f32 at
that shape, on the tensor cores in 3xTF32) and ``csrc/ssd_scan.cu``
(every other case, on the CUDA cores in f32).  ``path(dtype, P, N)``
names the one that runs; the choice depends on the dtype and the shape
alone.

Layout, as the Pallas kernel's: x (B, H, S, P); dA and dt (B, H, S) f32;
Bm and Cm (B, G, S, N) with G dividing H — head h reads group
h // (H / G), so the model's groups need no repeat to H heads (G = H is
the Pallas layout); h0 (B, H, P, N) f32 or None (zeros).  x, Bm and Cm
are all f32 or all bf16, N is at most 128.  Returns (y (B, H, S, P) in
x's dtype, final state (B, H, P, N) f32).

Every kernel takes chunks of ``CHUNK`` rows whatever the caller's chunk:
the SSD is the same function for any chunking, and 64 rows is one
warpgroup's M.  Given CUDA tensors the wrapper launches the kernel of its
path on PyTorch's current stream (the tensor-core paths are two
launches, the pass over the chunks and the output, counted as one call)
and adds one to ``ssd_scan.launches`` and to
``ssd_scan.launches_by_path[path]``; a build or launch that fails
raises, and nothing falls back to another kernel.  Given CPU tensors it
computes the same function with the plain version (``ref.ssd_scan_ref``
at the kernels' chunk) and launches nothing.

The gradient: ``ssd_scan_bwd`` wraps three kernels as the forward does,
and ``bwd_path(dtype, P, N)``, the forward's ``path``, names the one that
runs: ``csrc/ssd_scan_bwd_wgmma.cu`` for bf16 at WGMMA_SHAPE (three
launches), ``csrc/ssd_scan_bwd_tf32.cu`` for f32 there (3xTF32, three
launches) and ``csrc/ssd_scan_bwd.cu`` for every other case (f32 on the
CUDA cores, head dim up to 64, d_state up to 128; four launches).  A call
counts one in ``ssd_scan_bwd.launches`` and in
``ssd_scan_bwd.launches_by_path[path]``; nothing falls back to another
kernel.  On CPU tensors it is the plain ``ref.ssd_scan_bwd_ref`` at the
kernels' chunk.  ``SSDScanFn`` is the ``torch.autograd.Function`` that
pairs the forward kernel with it; ``ssd_scan_fn`` applies it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, _scratch, ref

#: rows per chunk inside the kernel
CHUNK = 64
#: the largest d_state the kernels take
MAX_STATE = 128
#: the largest head dim the backward kernel takes
MAX_BWD_HEAD_DIM = 64
#: (head dim, d_state) of the tensor-core paths: mamba2's shape
WGMMA_SHAPE = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def path(dtype: torch.dtype, head_dim: int, d_state: int) -> str:
    """The kernel that computes the scan of `dtype` at this head dim and
    d_state on the card: "wgmma" (bf16 at WGMMA_SHAPE), "tf32" (f32 at
    WGMMA_SHAPE) or "simt" (any other shape)."""
    if (head_dim, d_state) != WGMMA_SHAPE:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32"


def bwd_path(dtype: torch.dtype, head_dim: int, d_state: int) -> str:
    """The kernel that computes the scan's gradient of `dtype` at this
    head dim and d_state on the card: the forward's path ("wgmma",
    "tf32" or "simt")."""
    return path(dtype, head_dim, d_state)


def _check_aligned(**tensors):
    """The tensor maps need 16-byte aligned bases."""
    for name, a in tensors.items():
        if a.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes: tuple,
           device: torch.device):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_all(x, dA, dt, Bm, Cm, h0):
    """Validate the forward's inputs; returns (B, H, S, P, G, N)."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-d, got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}")
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x is on {x.device}: the port runs on the CPU or a "
                         "CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not group over {G} B/C groups")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"d_state {N} outside 1..{MAX_STATE}")
    dev = x.device
    _check("x", x, (B, H, S, P), _DTYPES, dev)
    _check("dA", dA, (B, H, S), (torch.float32,), dev)
    _check("dt", dt, (B, H, S), (torch.float32,), dev)
    _check("Bm", Bm, (B, G, S, N), (x.dtype,), dev)
    _check("Cm", Cm, (B, G, S, N), (x.dtype,), dev)
    if h0 is not None:
        _check("h0", h0, (B, H, P, N), (torch.float32,), dev)
    return B, H, S, P, G, N


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, S, P); dA, dt (B, H, S) f32; Bm, Cm (B, G, S, N);
    h0 (B, H, P, N) f32 or None -> (y (B, H, S, P), h (B, H, P, N) f32)."""
    B, H, S, P, G, N = _check_all(x, dA, dt, Bm, Cm, h0)
    dev = x.device
    if dev.type == "cpu":
        return ref.ssd_scan_ref(x, dA, dt, Bm, Cm, h0, chunk=CHUNK)
    y = torch.empty_like(x)
    if x.numel() == 0:
        h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
             if h0 is None else h0.clone())
        return y, h
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    h0_ptr = None if h0 is None else h0.data_ptr()
    kernel = path(x.dtype, P, N)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel in ("wgmma", "tf32"):
            _check_aligned(x=x, Bm=Bm, Cm=Cm)
            # the state entering each chunk, (B, H, ceil(S / CHUNK), P, N):
            # bf16 high and low parts on wgmma, f32 on tf32, 4 bytes each
            hin = _scratch.scratch(dev, stream,
                                   B * H * -(-S // CHUNK) * P * N * 4)
            lib = _build.load(f"ssd_scan_{kernel}")
            err = getattr(lib, f"ssd_scan_{kernel}_fwd")(
                x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), h0_ptr, y.data_ptr(), h.data_ptr(),
                hin.data_ptr(), B, H, G, S, stream)
        else:
            err = _build.load("ssd_scan").ssd_scan_fwd(
                x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), h0_ptr, y.data_ptr(), h.data_ptr(), B, H, G,
                S, P, N, int(x.dtype == torch.bfloat16), stream)
    _build.check_launch(err, f"ssd_scan ({kernel})")
    ssd_scan.launches += 1
    ssd_scan.launches_by_path[kernel] += 1
    return y, h


ssd_scan.launches = 0
ssd_scan.launches_by_path = {"wgmma": 0, "tf32": 0, "simt": 0}


def ssd_scan_bwd(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor], dy: torch.Tensor,
                 dh: Optional[torch.Tensor] = None, with_dh0: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``ssd_scan``: its inputs, dy (B, H, S, P) in x's dtype
    (the loss's gradient by y) and dh (B, H, P, N) f32 by the final state
    (None: zeros).  Returns (dx, ddA, ddt, dB, dC, dh0): dx in x's dtype,
    ddA and ddt f32, dB and dC (B, G, S, N) in Bm's dtype, summed over
    each group's heads, dh0 f32 or None unless `with_dh0`."""
    B, H, S, P, G, N = _check_all(x, dA, dt, Bm, Cm, h0)
    dev = x.device
    _check("dy", dy, (B, H, S, P), (x.dtype,), dev)
    if dh is not None:
        _check("dh", dh, (B, H, P, N), (torch.float32,), dev)
    if dev.type == "cpu":
        dx, ddA, ddt, dB, dC, dh0 = ref.ssd_scan_bwd_ref(
            x, dA, dt, Bm, Cm, h0, dy, dh, chunk=CHUNK)
        return dx, ddA, ddt, dB, dC, dh0 if with_dh0 else None
    kernel = bwd_path(x.dtype, P, N)
    if kernel == "simt" and P > MAX_BWD_HEAD_DIM:
        raise ValueError(f"head dim {P} above the backward kernel's "
                         f"{MAX_BWD_HEAD_DIM}")
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddA, ddt = torch.empty_like(dA), torch.empty_like(dt)
    dh0 = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
           if with_dh0 else None)
    if x.numel() == 0:
        for t in (dB, dC, ddA, ddt):
            t.zero_()
        if dh0 is not None:
            dh0.copy_(torch.zeros_like(dh0) if dh is None else dh)
        return dx, ddA, ddt, dB, dC, dh0
    ptrs = (x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            dy.data_ptr(), None if dh is None else dh.data_ptr(),
            dx.data_ptr(), ddA.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), None if dh0 is None else dh0.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel in ("wgmma", "tf32"):
            _check_aligned(x=x, dy=dy, Bm=Bm, Cm=Cm)
            name = f"ssd_scan_bwd_{kernel}"
            lib = _build.load(name)
            # the states entering the chunks and the gradients by the
            # states leaving them (bf16 hi + lo on wgmma, f32 on tf32), and
            # the head tiles' dB and dC partials (f32)
            buf = _scratch.scratch(
                dev, stream,
                getattr(lib, f"{name}_scratch_bytes")(B, H, G, S))
            err = getattr(lib, name)(*ptrs, buf.data_ptr(), B, H, G, S,
                                     stream)
        else:
            lib = _build.load("ssd_scan_bwd")
            # the chunks' states and state gradients, their last cum, and
            # the heads' dB and dC partials, all f32
            buf = _scratch.scratch(
                dev, stream, lib.ssd_scan_bwd_scratch_bytes(B, H, S, P, N))
            err = lib.ssd_scan_bwd(*ptrs, buf.data_ptr(), B, H, G, S, P, N,
                                   int(x.dtype == torch.bfloat16), stream)
    _build.check_launch(err, f"ssd_scan_bwd ({kernel})")
    ssd_scan_bwd.launches += 1
    ssd_scan_bwd.launches_by_path[kernel] += 1
    return dx, ddA, ddt, dB, dC, dh0


ssd_scan_bwd.launches = 0
ssd_scan_bwd.launches_by_path = {"wgmma": 0, "tf32": 0, "simt": 0}


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` with its hand-written gradient: the forward kernel of
    its path, then ``ssd_scan_bwd`` on the saved inputs.  A gradient that
    autograd does not supply (y or the final state unused) is zeros."""

    @staticmethod
    def forward(ctx, x, dA, dt, Bm, Cm, h0):
        ctx.set_materialize_grads(False)
        y, h = ssd_scan(x, dA, dt, Bm, Cm, h0)
        ctx.save_for_backward(x, dA, dt, Bm, Cm, h0)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dA, dt, Bm, Cm, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        return ssd_scan_bwd(x, dA, dt, Bm, Cm, h0, dy, dh,
                            with_dh0=ctx.needs_input_grad[5])


def ssd_scan_fn(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan`` that autograd differentiates with the backward kernel
    (its plain version on CPU tensors)."""
    return SSDScanFn.apply(x, dA, dt, Bm, Cm, h0)


def reset_launches():
    """Zero the launch counts of the forward and the backward, the total
    and each path's."""
    for fn in (ssd_scan, ssd_scan_bwd):
        fn.launches = 0
        for key in fn.launches_by_path:
            fn.launches_by_path[key] = 0
