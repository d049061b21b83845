"""Parameters of the JAX package's models, as numpy arrays, into the
port's layout.

The reference stores the periodic body of the model stacked per pattern
position (``body["p0"]`` holds every period's first layer on a leading
axis); the port keeps one dict per layer in layer order.  Random init
cannot be reproduced across frameworks, so this is how the port and the
reference are held to the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.predictor import resolve_device
from .model import block_structure, check_supported


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """`tree`: the reference's parameter pytree (``repro.models.model.
    init_params``) with numpy leaves.  Returns the port's parameters on
    `device` (the card unless the caller names another), dtypes kept."""
    check_supported(cfg)
    dev = resolve_device(device)
    to_t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    head_s, period_s, n_periods, tail_s = block_structure(cfg)
    layers: list[Any] = [_map(to_t, p) for p in tree["head"]]
    body = tree["body"]
    for j in range(n_periods):
        for pi in range(len(period_s)):
            layers.append(_map(lambda a: to_t(a[j]), body[f"p{pi}"]))
    layers += [_map(to_t, p) for p in tree["tail"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers converted, "
                         f"config has {cfg.n_layers}")
    out = {"embed": _map(to_t, tree["embed"]),
           "final_norm": _map(to_t, tree["final_norm"]),
           "layers": layers}
    if "lm_head" in tree:
        out["lm_head"] = _map(to_t, tree["lm_head"])
    return out
