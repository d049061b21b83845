"""AdamW from scratch (port of ``repro.optim.adamw``): fp32 master
weights, configurable moment dtype, decoupled weight decay, global-norm
clipping, warmup+cosine schedule.

The optimizer state is congruent with the parameter tree (nested dicts
and lists of tensors).  The reference's ``update`` is functional; this
one updates the parameters and both moments in place, one leaf at a
time, and returns the same trees, so a step at recurrentgemma-2b's width
holds the weights, gradients and moments once (some 43 GB in f32) and a
single leaf's temporaries besides.  A leaf of more than SLICE_ELEMENTS
elements is updated in slices along its first axis: the update is
elementwise, so the result is bitwise the same, and the f32 temporaries
of bf16 state (some six copies at once) stay a slice's size rather than
the leaf's (deepseek-v2's stacked experts are 1.26e9 elements, 5 GB a
copy).  The step count, the learning rate and the clip scale stay on the
parameters' device as 0-d tensors: a step never waits for the card.
DTensor leaves (a mesh step's) are updated on each rank's own shards,
the global norm taken over their global values.

Weight decay skips norms, biases and scalars by name, as the reference
does: its rule reads ``str(path[-1])`` of a JAX key path, ``"['bias1']"``
for a dict key and ``"[0]"`` for a list index, and this port builds the
same strings (``leaves_with_path``), so it decays the same leaves.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Tuple

import torch

from ..models.pctx import is_dtensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
#: leaves above this many elements are updated a slice of the first axis
#: at a time (2^26: 256 MB an f32 temporary)
SLICE_ELEMENTS = 1 << 26


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor      # int32, 0-d


def leaves_with_path(tree, path: Tuple[str, ...] = ()
                     ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) in order, each path element in the string form of a
    JAX key path entry: ``"['key']"`` for a dict key, ``"[i]"`` for a
    list index."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in leaves_with_path(v, path + (f"[{k!r}]",))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_path(v, path + (f"[{i}]",))]
    return [(path, tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _device(tree) -> torch.device:
    leaves = leaves_with_path(tree)
    return leaves[0][1].device if leaves else torch.device("cpu")


def init(params, cfg: AdamWConfig) -> OptState:
    mdt = _DTYPES[cfg.moment_dtype]
    # zeros_like: DTensor parameters get moments of their placements
    zeros = lambda p: torch.zeros_like(p, dtype=mdt,
                                       memory_format=torch.contiguous_format)
    return OptState(m=_map(zeros, params), v=_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=_device(params)))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr, in f32; `step`
    a number or a tensor (the result lies on its device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """The global L2 norm of the tree's leaves; of DTensor leaves, the
    norm of their global values, as a plain tensor."""
    leaves = [t for _, t in leaves_with_path(tree)]
    norm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))
    return norm.full_tensor() if is_dtensor(norm) else norm


def _local(p, g, m, v):
    """The local shards of a DTensor leaf's parameter, gradient and
    moments, which share one set of placements (the update is
    elementwise, so each rank updates its own shards); plain tensors as
    they are."""
    if not is_dtensor(p):
        return p, g, m, v
    if not (tuple(p.placements) == tuple(g.placements)
            == tuple(m.placements) == tuple(v.placements)):
        raise ValueError("parameter, gradient and moments are placed "
                         "differently")
    return p.to_local(), g.to_local(), m.to_local(), v.to_local()


def _decayable(path) -> bool:
    """No weight decay on norms / biases / scalars (standard practice)."""
    name = str(path[-1]) if path else ""
    return not any(t in name for t in ("scale", "bias", "b_", "a_param",
                                       "A_log", "dt_bias", "D"))


@torch.no_grad()
def update(params, grads, state: OptState, cfg: AdamWConfig):
    """-> (params, new_state, metrics), everything fp32 math.  The
    parameters and moments are updated in place (the returned trees are
    the ones passed in); the state's step is a new tensor."""
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    step = state.step + 1
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, sf)
    b2c = 1 - torch.pow(cfg.b2, sf)
    p_leaves = leaves_with_path(params)
    g_leaves = [t for _, t in leaves_with_path(grads)]
    m_leaves = [t for _, t in leaves_with_path(state.m)]
    v_leaves = [t for _, t in leaves_with_path(state.v)]
    if not (len(p_leaves) == len(g_leaves) == len(m_leaves)
            == len(v_leaves)):
        raise ValueError("params, grads and moments are not congruent")
    for (path, p), g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        p, g, m, v = _local(p, g, m, v)
        decay = _decayable(path)
        n = p.shape[0] if p.dim() else 0
        rows = max(1, SLICE_ELEMENTS * n // max(p.numel(), 1))
        if rows >= n:
            _update_leaf(p, g, m, v, cfg, scale, lr, b1c, b2c, decay)
            continue
        for i in range(0, n, rows):
            s = slice(i, i + rows)
            _update_leaf(p[s], g[s], m[s], v[s], cfg, scale, lr, b1c, b2c,
                         decay)
    return params, OptState(state.m, state.v, step), {"grad_norm": gnorm,
                                                      "lr": lr}


def _update_leaf(p, g, m, v, cfg: AdamWConfig, scale, lr, b1c, b2c,
                 decay: bool):
    """One leaf's (or slice's) update in f32, written back in place into
    p, m and v in their own dtypes."""
    g = g.float() * scale
    m32 = m if m.dtype == torch.float32 else m.float()
    m32.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v32 = v if v.dtype == torch.float32 else v.float()
    v32.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
    upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
    p32 = p if p.dtype == torch.float32 else p.float()
    if decay:
        upd = upd + cfg.weight_decay * p32
    p32.sub_(lr * upd)
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if src is not dst:
            dst.copy_(src)
