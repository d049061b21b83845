"""Production mesh definition on NVIDIA H100 SXM5 (port of
``repro.launch.mesh``).

``make_production_mesh`` and ``make_smoke_mesh`` are functions (never
module-level constants), so importing this module builds nothing and
touches no process group.  They return ``init_device_mesh`` over the
default process group, which the caller has started with as many ranks
as the mesh has devices (``torchrun``, or a ``fake`` process group for
the dry run): on "cuda" unless asked for another device type, as the
tests and the dry run ask for "cpu".
"""
from __future__ import annotations

# H100 SXM5 hardware constants (per GPU), used by the roofline analysis.
# Dense bf16 tensor-core peak, without sparsity: 989 TFLOP/s (NVIDIA H100
# Tensor Core GPU datasheet, SXM5 column); chip_smoke.py's kernel bounds
# use the same figure.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
# HBM3: 3.35 TB/s (the same datasheet, SXM5 80 GB).
HBM_BW = 3.35e12              # bytes/s
# NVLink 4 inside an 8-GPU HGX node: 900 GB/s per GPU in both directions,
# 450 GB/s a direction (the datasheet's NVLink row).
NVLINK_BW = 450e9             # bytes/s a direction
# Across nodes: one NDR InfiniBand port of 400 Gb/s per GPU, 50 GB/s a
# direction (the ConnectX-7 rate of a DGX H100 / HGX H100 node).
IB_BW = 50e9                  # bytes/s a direction
# The collective term's link.  The production mesh's "model" axis is 16
# GPUs wide, two 8-GPU nodes, and "data" / "pod" span nodes too, so every
# ring a collective runs on crosses InfiniBand, and a ring moves data no
# faster than its slowest hop: the term uses IB_BW.
LINK_BW = IB_BW


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with `multi_pod`: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_smoke_mesh(n_data: int = 2, n_model: int = 2, n_pod: int = 0,
                    device_type: str = "cuda"):
    """Small mesh for tests: (n_data, n_model), or (n_pod, n_data,
    n_model) with a pod axis."""
    if n_pod:
        return _mesh(device_type, (n_pod, n_data, n_model),
                     ("pod", "data", "model"))
    return _mesh(device_type, (n_data, n_model), ("data", "model"))
