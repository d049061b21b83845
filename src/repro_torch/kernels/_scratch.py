"""Scratch memory that the kernel wrappers hand to their kernels: one
buffer per (device, stream), grown when a call needs more and kept, so
that a steady caller allocates nothing per call.  Calls on one stream run
in order, so each may reuse what the one before it used; a call on
another stream gets a buffer of its own."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_BUFFERS: Dict[Tuple[str, int], torch.Tensor] = {}


def current_stream(device: torch.device) -> int:
    """The handle of `device`'s current stream, as the entry points take
    it: ``torch.cuda.current_stream(device).cuda_stream`` without building
    a Stream object, which costs a launch a few microseconds on the
    host."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def scratch(device: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """At least `nbytes` bytes (uint8) on `device`, for kernels queued on
    `stream` (its ``cuda_stream`` handle); 256-byte aligned, as every
    allocation of PyTorch's caching allocator is."""
    key = (str(device), stream)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        _BUFFERS[key] = buf
    return buf


def clear() -> None:
    """Drop every buffer, so that the next caller's memory holds only the
    scratch its own calls ask for."""
    _BUFFERS.clear()
