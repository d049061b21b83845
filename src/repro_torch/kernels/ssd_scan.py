"""Mamba-2 SSD chunked scan: the wrapper around the Hopper kernel in
``csrc/ssd_scan.cu``.

Layout, as the Pallas kernel's: x (B, H, S, P); dA and dt (B, H, S) f32;
Bm and Cm (B, G, S, N) with G dividing H — head h reads group
h // (H / G), so the model's groups need no repeat to H heads (G = H is
the Pallas layout); h0 (B, H, P, N) f32 or None (zeros).  x, Bm and Cm
are all f32 or all bf16, N is at most 128.  Returns (y (B, H, S, P) in
x's dtype, final state (B, H, P, N) f32).

The kernel walks the sequence in chunks of ``CHUNK`` rows whatever the
caller's chunk: the SSD is the same function for any chunking, and 64
rows is what fits shared memory.  Given CUDA tensors the wrapper launches
the kernel on PyTorch's current stream and adds one to
``ssd_scan.launches``; a launch the runtime refuses raises.  Given CPU
tensors it computes the same function with the plain version
(``ref.ssd_scan_ref`` at the kernel's chunk) and launches nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref

#: rows per chunk inside the kernel
CHUNK = 64
#: the largest d_state the kernel takes
MAX_STATE = 128
_DTYPES = (torch.float32, torch.bfloat16)


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


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, S, P); dA, dt (B, H, S) f32; Bm, Cm (B, G, S, N);
    h0 (B, H, P, N) f32 or None -> (y (B, H, S, P), h (B, H, P, N) f32)."""
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
    if dev.type == "cpu":
        return ref.ssd_scan_ref(x, dA, dt, Bm, Cm, h0, chunk=CHUNK)
    y = torch.empty_like(x)
    if x.numel() == 0:
        h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
             if h0 is None else h0.clone())
        return y, h
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    lib = _build.load("ssd_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h.data_ptr(), B, H, G, S, P, N,
            int(x.dtype == torch.bfloat16), stream)
    _build.check_launch(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
