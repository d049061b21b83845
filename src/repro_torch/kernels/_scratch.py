"""Scratch memory that the kernel wrappers hand to their kernels: one
buffer per (device, stream), grown when a call needs more and kept, so
that a steady caller allocates nothing per call.  Calls on one stream run
in order, so each may reuse what the one before it used; a call on
another stream gets a buffer of its own.

A CUDA graph bakes the addresses of the buffers its kernels were handed
into its replays, so a capture collects them (``held``) and its graph
keeps them: growing a buffer later only replaces it here, and memory a
graph still writes is never freed while the graph lives."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

_BUFFERS: Dict[Tuple[str, int], torch.Tensor] = {}
#: for each ``held`` block in progress, the buffers handed out inside it
_HELD: List[List[torch.Tensor]] = []


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
    for bufs in _HELD:
        if all(b is not buf for b in bufs):
            bufs.append(buf)
    return buf


@contextmanager
def held():
    """A list of every buffer ``scratch`` hands out inside the block, for
    the graph captured there to keep for as long as it lives."""
    bufs: List[torch.Tensor] = []
    _HELD.append(bufs)
    try:
        yield bufs
    finally:
        _HELD[:] = [b for b in _HELD if b is not bufs]


def clear() -> None:
    """Drop every buffer, so that the next caller's memory holds only the
    scratch its own calls ask for (and what live graphs keep)."""
    _BUFFERS.clear()
