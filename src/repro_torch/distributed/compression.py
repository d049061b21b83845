"""Gradient compression for the cross-pod data-parallel all-reduce (port
of ``repro.distributed.compression``).

int8 error-feedback quantization: each step quantizes (grad + carried
residual) to per-tensor-scaled int8, all-reduces the int8 payload (8x less
inter-node traffic than f32, 4x less than bf16), dequantizes, and carries
the quantization error into the next step (error feedback keeps SGD/Adam
convergence — Karimireddy et al., 2019).

Exposed as

  * pure functions (`quantize`/`dequantize`/`ef_quantize`): the same
    arithmetic in the same order as the reference, so the payloads are
    bitwise its own (``torch.round`` and ``jnp.round`` both round half
    to even),
  * `compressed_psum(g, group, err)`: the collective over a process
    group or one dimension of a ``DeviceMesh``,
  * `compress_grads_tree(grads, err)`: the local round trip of a whole
    gradient tree, which models the wire format when there is one pod.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 payload, f32 scale). Symmetric per-tensor scaling."""
    g32 = g.to(torch.float32)
    # divided by a tensor on g's device: CUDA divides by a Python scalar
    # as a product with its reciprocal, which rounds otherwise
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-30) / \
        torch.full((), 127.0, device=g.device)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_quantize(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantize: -> (payload, scale, new_err)."""
    target = g.to(torch.float32) + err
    q, scale = quantize(target)
    new_err = target - dequantize(q, scale)
    return q, scale, new_err


def _group(group):
    """A process group from `group`: a ProcessGroup (or None, the
    default group), a one-dimensional DeviceMesh, or (mesh, axis name)."""
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(axis)
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def compressed_psum(g: torch.Tensor, group, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce an int8-quantized gradient over `group` (a process
    group, a one-dimensional ``DeviceMesh`` or (mesh, axis name)).
    Returns (mean gradient (f32), new error-feedback residual)."""
    import torch.distributed as dist
    pg = _group(group)
    q, scale, new_err = ef_quantize(g, err)
    # int8 payloads sum without overflow in i32; scales averaged.
    tot = q.to(torch.int32)
    dist.all_reduce(tot, group=pg)
    n = torch.ones((), dtype=torch.float32, device=g.device)
    dist.all_reduce(n, group=pg)
    s = scale.clone()
    dist.all_reduce(s, group=pg)
    mean_scale = s / n
    return tot.to(torch.float32) * mean_scale / n, new_err


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def init_error_state(grads_abs) -> Any:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads_abs)


def compress_grads_tree(grads, err_state):
    """Local (no collective) EF-compression round-trip of a grad tree —
    models the pod-axis wire format; returns (dequantized grads, new err).
    """
    out_g, out_e = [], []
    for g, e in zip(_leaves(grads), _leaves(err_state)):
        q, s, ne = ef_quantize(g, e)
        out_g.append(dequantize(q, s).to(g.dtype))
        out_e.append(ne)
    it_g, it_e = iter(out_g), iter(out_e)
    return _map(lambda _: next(it_g), grads), _map(lambda _: next(it_e),
                                                  grads)
