"""The train step's AdamW update and global gradient norm: wrappers around
the Hopper kernels in ``csrc/adamw.cu``, the counterpart of the fusion
XLA gives the reference's jitted step.

``adamw_update(p, g, m, v, cfg, scale, lr, b1c, b2c, decay, held=None)``
updates one leaf in place with one launch: one read of p, g, m and v
and one write of p, m and v, bitwise ``optim.adamw._update_leaf`` (its
plain version); given `held`, the f32 leaf's bf16 working copy, the same
launch also writes the new p there, bitwise ``p.to(torch.bfloat16)``
(the plain version: ``_update_leaf`` then ``held.copy_(p)``).
It adds one to ``adamw_update.launches`` and to
``adamw_update.launches_by_path[path]``: "vector" where the arrays
share a 16-byte aligned element (the body in vectors of 8, the head and
tail element by element), "scalar" where they do not (the whole leaf
element by element).

``grad_norm(leaves)`` is the L2 norm of the leaves as a 0-d f32 tensor:
one launch a leaf writes f32 partial sums of squares, one block's each,
and one more sums every partial in f64 in a fixed order to the square
root; no atomics, so two calls are bitwise equal.  It adds one to
``grad_norm.launches`` a call, and the launches themselves to
``grad_norm.launches_by_path`` ("partials" a leaf, "sum" a call).
``grad_sumsq(groups)`` is the same for groups of leaves, each group's
sum of squares in f64 without the root (a mesh step adds each group's
sum across the ranks it is sharded over before it), one call counted.

Given CUDA tensors the wrappers launch on PyTorch's current stream; a
build or launch that fails raises, and nothing falls back.  Given CPU
tensors they compute the same function with the plain versions
(``optim.adamw._update_leaf`` and ``global_norm``) and launch nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import _build
from ._scratch import current_stream, scratch

#: the kernels' dtype codes: weights and gradients f32 or bf16 in the
#: update, moments also f16; gradients of any of the three in the norm
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PG_DTYPES = (torch.float32, torch.bfloat16)
#: elements a thread takes at a time, as 16-byte vectors
VEC = 8


def body(*tensors: torch.Tensor) -> Optional[int]:
    """The first element (0-7) at which every tensor's address is 16-byte
    aligned, or None where there is none."""
    for head in range(VEC):
        if all((t.data_ptr() + head * t.element_size()) % 16 == 0
               for t in tensors):
            return head
    return None


def dense_span(x: torch.Tensor) -> torch.Tensor:
    """x's elements as a 1-d view of its storage where they fill one
    contiguous span in some order (a contiguous tensor, or a permutation
    of one: the layout autograd gives some gradients), else as a
    contiguous copy.  A sum of squares reads them in any order."""
    expect = 1
    for stride, size in sorted((st, sz) for st, sz in zip(x.stride(),
                                                           x.shape)
                               if sz != 1):
        if stride != expect:
            return x.contiguous().view(-1)
        expect *= size
    return x.as_strided((x.numel(),), (1,))


def _split(n: int, head: Optional[int]):
    """(head, nvec) of a leaf of `n` elements whose body starts at `head`
    (None: no body, every element on its own)."""
    if head is None or head >= n:
        return n, 0
    return head, (n - head) // VEC


def _check(name: str, t: torch.Tensor, like: torch.Tensor):
    dtypes = _PG_DTYPES if name in ("p", "g") else tuple(_CODES)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} is {tuple(t.shape)}, p "
                         f"{tuple(like.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, p on {like.device}")


def _scalar(name: str, t: torch.Tensor, device: torch.device):
    if t.dim() != 0 or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be a 0-d float32 tensor on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, cfg, scale: torch.Tensor, lr: torch.Tensor,
                 b1c: torch.Tensor, b2c: torch.Tensor, decay: bool,
                 held: Optional[torch.Tensor] = None) -> str:
    """One leaf's AdamW update in place: p and g f32 or bf16, m and v of
    one dtype (f32, bf16 or f16), all of p's shape; `cfg` an ``AdamWConfig``
    (b1, b2, eps, weight_decay); scale, lr, b1c, b2c 0-d f32 tensors on
    p's device; `held`, where given, a bf16 tensor of p's shape (p f32)
    that takes the new p.  Returns the path that ran ("vector", "scalar";
    "plain" on the CPU, "empty" for a leaf of no elements)."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"p is on {p.device}: the port runs on the CPU or "
                         "a CUDA device")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _check(name, t, p)
    if held is not None:
        _check("held", held, p)
        if held.dtype != torch.bfloat16 or p.dtype != torch.float32:
            raise TypeError(f"held must be bfloat16 beside float32 p, got "
                            f"{held.dtype} beside {p.dtype}")
    if m.dtype != v.dtype:
        raise TypeError(f"m is {m.dtype}, v {v.dtype}: the moments share "
                        "one dtype")
    for name, t in (("scale", scale), ("lr", lr), ("b1c", b1c),
                    ("b2c", b2c)):
        _scalar(name, t, p.device)
    if p.device.type == "cpu":
        from ..optim.adamw import _update_leaf
        _update_leaf(p, g, m, v, cfg, scale, lr, b1c, b2c, decay)
        if held is not None:
            held.copy_(p)
        return "plain"
    written = (("p", p), ("m", m), ("v", v)) + (
        (("held", held),) if held is not None else ())
    for name, t in written:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: it is updated in "
                             "place")
    g = g.contiguous()
    n = p.numel()
    if n == 0:
        return "empty"
    head, nvec = _split(n, body(*(t for _, t in written), g))
    kernel = "vector" if nvec else "scalar"
    lib = _build.load("adamw")
    with torch.cuda.device(p.device):
        err = lib.adamw_update(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if held is None else held.data_ptr(),
            _CODES[p.dtype], _CODES[g.dtype], _CODES[m.dtype], n, head,
            nvec, scale.data_ptr(), lr.data_ptr(), b1c.data_ptr(),
            b2c.data_ptr(), cfg.b1,
            1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps, cfg.weight_decay,
            int(decay), current_stream(p.device))
    _build.check_launch(err, f"adamw_update ({kernel})")
    # the update wrote p, m and v (and held) behind autograd's back
    for _, t in written:
        torch.autograd.graph.increment_version(t)
    adamw_update.launches += 1
    adamw_update.launches_by_path[kernel] += 1
    return kernel


adamw_update.launches = 0
adamw_update.launches_by_path = {"vector": 0, "scalar": 0}


def _sumsq(groups: Sequence[Sequence[torch.Tensor]],
           want_norm: bool) -> torch.Tensor:
    """The kernels' sums of squares of groups of CUDA leaves: the f32
    norm of the one group, or each group's f64 sum."""
    dev = next(x.device for group in groups for x in group)
    plan, bounds, total = [], [], 0
    lib = _build.load("adamw")
    for group in groups:
        start = total
        for x in group:
            if x.device != dev:
                raise ValueError(f"a leaf is on {x.device}, another on {dev}")
            if x.dtype not in _CODES:
                raise TypeError(f"leaves must be float32, bfloat16 or "
                                f"float16, got {x.dtype}")
            x = dense_span(x)
            n = x.numel()
            if n == 0:
                continue
            head, nvec = _split(n, body(x))
            plan.append((x, n, head, nvec, total))
            total += lib.grad_sumsq_blocks(nvec)
        bounds.append((start, total - start))
    out = (torch.empty((), dtype=torch.float32, device=dev) if want_norm
           else torch.empty(len(groups), dtype=torch.float64, device=dev))
    with torch.cuda.device(dev):
        stream = current_stream(dev)
        partials = scratch(dev, stream, 4 * max(total, 1))
        base = partials.data_ptr()
        for x, n, head, nvec, off in plan:
            err = lib.grad_sumsq_partials(
                x.data_ptr(), _CODES[x.dtype], n, head, nvec,
                base + 4 * off, stream)
            _build.check_launch(err, "grad_norm (partials)")
            grad_norm.launches_by_path["partials"] += 1
        for i, (start, count) in enumerate(bounds):
            err = lib.grad_sumsq_finish(
                base + 4 * start, count,
                None if want_norm else out.data_ptr() + 8 * i,
                out.data_ptr() if want_norm else None, stream)
            _build.check_launch(err, "grad_norm (sum)")
            grad_norm.launches_by_path["sum"] += 1
    grad_norm.launches += 1
    return out


def grad_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of `leaves` (f32, bf16 or f16 tensors on one device) as a
    0-d f32 tensor."""
    leaves = list(leaves)
    if not leaves or leaves[0].device.type == "cpu":
        from ..optim.adamw import global_norm
        return global_norm(leaves)
    return _sumsq([leaves], want_norm=True)


grad_norm.launches = 0
grad_norm.launches_by_path = {"partials": 0, "sum": 0}


def grad_sumsq(groups: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Each group's sum of squares, an f64 tensor of one element a group:
    on the card the kernels' partials summed in f64 (one finish launch a
    group, one call counted); on the CPU each leaf's plain f32 sum,
    widened and added in f64."""
    groups = [list(group) for group in groups]
    leaves = [x for group in groups for x in group]
    if not leaves or leaves[0].device.type == "cpu":
        return torch.stack([
            sum((torch.sum(torch.square(x.float())).double() for x in group),
                torch.zeros((), dtype=torch.float64)) for group in groups])
    return _sumsq(groups, want_norm=False)


def reset_launches():
    """Zero the launch counts, the totals and each path's."""
    for fn in (adamw_update, grad_norm):
        fn.launches = 0
        for key in fn.launches_by_path:
            fn.launches_by_path[key] = 0
