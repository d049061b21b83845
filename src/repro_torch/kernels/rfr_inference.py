"""Random-forest batched inference: wrappers around the Hopper kernels
in ``csrc/rfr_inference.cu``.

Two kernels share one forest descent:

  * ``rfr_forest_apply`` — plain batched prediction, (N, F) -> (N,).
  * ``rfr_capacity_sweep`` — the fused capacity m-sweep over a padded
    scenario tensor (S, M, R, F) with per-row QoS bounds (S, M, R),
    returning the max admissible m per scenario as (S,) int32.

A wrapper given CUDA tensors launches its kernel on PyTorch's current
stream and adds one to its ``launches`` count; a launch the runtime
refuses raises.  Given CPU tensors it computes the same function with
the plain version in ``ref`` and launches nothing.  Empty shapes return
zeros without a launch on either device.

``forest_path(T, D)`` names where ``rfr_forest_apply``'s kernel reads the
forest from: "shared" (copied into shared memory by each block) or
"global" (device memory, for forests above ``FOREST_SMEM_BYTES``).
"""
from __future__ import annotations

import torch

from . import _build, ref

#: the packed forest's share of a block's shared memory on sm_90 (232,448
#: bytes): 192 KiB, which holds 64 trees of depth 8; the 35,840 bytes left
#: hold two passes of 64 rows of up to 70 features (the kernel reads wider
#: rows from device memory)
FOREST_SMEM_BYTES = 192 * 1024


def packed_forest_bytes(n_trees: int, depth: int) -> int:
    """Bytes of the forest as the kernels stage it: an 8-byte node
    (feature, threshold) per split and a 4-byte leaf."""
    nn = (1 << depth) - 1
    return n_trees * (8 * nn + 4 * (nn + 1))


def forest_path(n_trees: int, depth: int) -> str:
    """"shared" where the packed forest fits FOREST_SMEM_BYTES, else
    "global": the choice depends on the forest's bytes alone."""
    if packed_forest_bytes(n_trees, depth) <= FOREST_SMEM_BYTES:
        return "shared"
    return "global"


def _check_forest(feat: torch.Tensor, thr: torch.Tensor,
                  leaf: torch.Tensor, device: torch.device) -> int:
    """Validate the complete-tree forest arrays; returns the depth."""
    depth = ref.forest_depth(feat)
    t, nn = feat.shape
    if t < 1:
        raise ValueError("forest has no trees")
    if thr.shape != feat.shape or tuple(leaf.shape) != (t, nn + 1):
        raise ValueError(f"forest shapes disagree: feat {tuple(feat.shape)}"
                         f", thr {tuple(thr.shape)}, leaf "
                         f"{tuple(leaf.shape)}")
    for name, a, dtype in (("feat", feat, torch.int32),
                           ("thr", thr, torch.float32),
                           ("leaf", leaf, torch.float32)):
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, x on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return depth


def _check_input(name: str, a: torch.Tensor, ndim: int):
    if a.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got "
                         f"{tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {a.device}: the port runs on the "
                         "CPU or a CUDA device")


def rfr_forest_apply(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                     leaf: torch.Tensor) -> torch.Tensor:
    """x: (N, F) f32; feat (T, 2^D-1) int32; thr (T, 2^D-1) f32; leaf
    (T, 2^D) f32, all on x's device.  Returns predictions (N,) f32."""
    _check_input("x", x, 2)
    depth = _check_forest(feat, thr, leaf, x.device)
    n, f = x.shape
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return ref.rfr_forest_ref(x, feat, thr, leaf)
    lib = _build.load("rfr_inference")
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    in_smem = forest_path(feat.shape[0], depth) == "shared"
    err = lib.rfr_forest_apply(x.data_ptr(), feat.data_ptr(), thr.data_ptr(),
                               leaf.data_ptr(), out.data_ptr(), n, f,
                               feat.shape[0], depth, int(in_smem),
                               x.device.index or 0, stream)
    _build.check_launch(err, "rfr_forest_apply")
    rfr_forest_apply.launches += 1
    return out


rfr_forest_apply.launches = 0


def rfr_capacity_sweep(x: torch.Tensor, bounds: torch.Tensor,
                       feat: torch.Tensor, thr: torch.Tensor,
                       leaf: torch.Tensor, *,
                       log_target: bool = False) -> torch.Tensor:
    """Fused capacity m-sweep.  x: (S, M, R, F) f32 feature rows;
    bounds: (S, M, R) f32 QoS bounds (+inf = padded row, always passes;
    -inf = m beyond the scenario's m_max, always fails); the forest as
    in ``rfr_forest_apply``.  With ``log_target`` predictions are
    exponentiated before the bound comparison.  Returns (S,) int32."""
    _check_input("x", x, 4)
    _check_input("bounds", bounds, 3)
    depth = _check_forest(feat, thr, leaf, x.device)
    s, m, r, f = x.shape
    if tuple(bounds.shape) != (s, m, r):
        raise ValueError(f"bounds {tuple(bounds.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if bounds.device != x.device:
        raise ValueError(f"bounds on {bounds.device}, x on {x.device}")
    if s == 0 or m == 0 or r == 0:
        return torch.zeros(s, dtype=torch.int32, device=x.device)
    if x.device.type == "cpu":
        return ref.rfr_capacity_sweep_ref(x, bounds, feat, thr, leaf,
                                          log_target=log_target)
    lib = _build.load("rfr_inference")
    out = torch.empty(s, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rfr_capacity_sweep(x.data_ptr(), bounds.data_ptr(),
                                 feat.data_ptr(), thr.data_ptr(),
                                 leaf.data_ptr(), out.data_ptr(), s, m, r, f,
                                 feat.shape[0], depth, int(log_target),
                                 x.device.index or 0, stream)
    _build.check_launch(err, "rfr_capacity_sweep")
    rfr_capacity_sweep.launches += 1
    return out


rfr_capacity_sweep.launches = 0


def reset_launches():
    """Zero both kernels' launch counts."""
    rfr_forest_apply.launches = 0
    rfr_capacity_sweep.launches = 0
