"""Roofline terms of a traced step (port of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh) cell, all in seconds per step on
the H100 SXM5 constants of ``launch.mesh``:

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = wire_bytes_per_device / LINK_BW

The reference reads these from XLA's compiled module: FLOPs and bytes
from the optimized HLO text (``hlo_stats``) and collective bytes from its
collective instructions (``collective_bytes``).  PyTorch compiles nothing
here, so the port counts the same keys on the step as it runs, with
:class:`TraceCounter`, a ``TorchDispatchMode`` that sees each rank's own
(local) operations beneath DTensor:

  * FLOPs: the formulas of ``torch.utils.flop_counter`` (what
    ``FlopCounterMode`` counts) for each local matmul, convolution and
    attention op;
  * bytes accessed: operand + result bytes of every dispatched local op
    other than views and collective waits (the reference's un-fused rule:
    each op reads its inputs and writes its outputs to HBM);
  * collective wire bytes: the ``_c10d_functional`` collectives DTensor
    issues, per kind, the largest of operand and result, all-reduce
    counted twice (the reduce and broadcast halves of a ring), with
    ``_counts`` and the ``_top`` twelve, as the reference.

A step run under ``FakeTensorMode`` (the dry run) is counted alike:
nothing is allocated, and ops on another fake mode's tensors (DTensor's
own shape propagation) are not the rank's work and are skipped.

``useful_ratio`` = MODEL_FLOPS / (FLOPs x devices) — how much of the
traced compute is the 6·N·D (train) / 2·N·D (inference) model math;
recompute, GShard dispatch one-hots, replicated work and the plain
attention's full score matrix all push it down.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import InputShape, ModelConfig
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# _c10d_functional op name -> the reference's collective kind
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


# ops that move no data: a collective's wait, aliases, allocations
_NO_TRAFFIC = ("wait_tensor", "detach", "alias", "lift_fresh", "empty",
               "empty_strided", "empty_like")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collective wire bytes of the local ops run
    under it (``with TraceCounter(fake_mode) as tc: step(*args)``).
    `fake_mode`: the ``FakeTensorMode`` whose tensors are the traced
    step's (None for a run on real tensors)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in _COLLECTIVES}
        self.counts = {k: 0.0 for k in _COLLECTIVES}
        self.top: list = []

    def _ours(self, ts) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return all(not isinstance(t, FakeTensor)
                   or t.fake_mode is self.fake_mode for t in ts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count the local ops beneath it
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if not self._ours(ins + outs):
            return out
        packet = func.overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns == "_c10d_functional":
            kind = _KIND.get(name)
            if kind is not None:
                wire = float(max(_nbytes(t) for t in ins + outs))
                if kind == "all-reduce":
                    wire *= 2
                self.coll[kind] += wire
                self.counts[kind] += 1
                self.top.append((wire, kind, 1.0, f"{func}"
                                 f"{[tuple(t.shape) for t in ins]}"[:140]))
        if packet in self._flops_of:
            self.flops += float(self._flops_of[packet](
                *args, **kwargs, out_val=out))
        if not (func.is_view or ns == "prim" or name in _NO_TRAFFIC):
            self.bytes += float(sum(_nbytes(t) for t in ins + outs))
        return out

    def stats(self) -> Dict[str, float]:
        """The reference's ``hlo_stats`` keys: per-device FLOPs and
        bytes accessed."""
        return {"flops": self.flops, "bytes accessed": self.bytes}

    def collectives(self) -> Dict[str, object]:
        """The reference's ``collective_bytes`` keys: per-kind wire bytes
        per device, ``_counts`` and ``_top``."""
        out: Dict[str, object] = dict(self.coll)
        out["_counts"] = dict(self.counts)
        top = sorted(self.top, reverse=True)[:12]
        out["_top"] = [{"bytes": b, "kind": k, "mult": m, "op": op}
                       for b, k, m, op in top]
        return out


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6·N·D (train) / 2·N·D (inference); N = active params for MoE."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per batch element
    return 2.0 * n * shape.global_batch


def roofline_terms(cost: dict, coll: Dict[str, float], n_devices: int,
                   cfg: Optional[ModelConfig] = None,
                   shape: Optional[InputShape] = None) -> dict:
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    wire = float(sum(v for k, v in coll.items() if not k.startswith("_")))
    terms = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": wire / LINK_BW,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_hbm,
        "wire_bytes_per_device": wire,
        "n_devices": n_devices,
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        terms["model_flops"] = mf
        terms["useful_ratio"] = mf / max(flops * n_devices, 1.0)
        # roofline fraction: useful model FLOPs per device-second achievable
        # given the *dominant* term as the step time.
        step_s = max(terms["compute_s"], terms["memory_s"],
                     terms["collective_s"])
        terms["roofline_frac"] = (mf / n_devices / max(step_s, 1e-30)
                                  / PEAK_FLOPS_BF16)
    return terms
