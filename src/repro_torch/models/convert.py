"""Parameters of the JAX package's models, as numpy arrays, into the
port's layout.

The reference stores the periodic body of the model stacked per pattern
position (``body["p0"]`` holds every period's first layer on a leading
axis); the port keeps one dict per layer in layer order.  Random init
cannot be reproduced across frameworks, so this is how the port and the
reference are held to the same weights.  ``params_to_numpy`` is the
inverse (the port's per-layer list stacked back into the reference's
tree), and ``train_state_from_numpy`` carries a whole train state, the
AdamW moments laid out as the parameters.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.predictor import resolve_device
from .model import block_structure


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
    for key in ("lm_head", "frontend_proj"):
        if key in tree:
            out[key] = _map(to_t, tree[key])
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """numpy has no bf16: bf16 leaves come back as f32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(cfg: ModelConfig, params):
    """The port's parameters (or any tree laid out like them, such as
    gradients or AdamW moments) as the reference's tree of numpy arrays:
    ``head`` and ``tail`` lists, ``body["p{i}"]`` stacked over the
    periods on a leading axis.  bf16 leaves come back as f32."""
    head_s, period_s, n_periods, tail_s = block_structure(cfg)
    layers = [_map(_to_numpy, p) for p in params["layers"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers, config has "
                         f"{cfg.n_layers}")
    n_head, P = len(head_s), len(period_s)
    body = {}
    for pi in range(P):
        per = [layers[n_head + j * P + pi] for j in range(n_periods)]
        body[f"p{pi}"] = _zip_map(lambda *leaves: np.stack(leaves), per)
    out = {"embed": _map(_to_numpy, params["embed"]),
           "final_norm": _map(_to_numpy, params["final_norm"]),
           "head": layers[:n_head], "body": body,
           "tail": layers[len(layers) - len(tail_s):] if tail_s else []}
    for key in ("lm_head", "frontend_proj"):
        if key in params:
            out[key] = _map(_to_numpy, params[key])
    return out


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_map(fn, [t[i] for t in trees]) for i in range(len(first))]
    return fn(*trees)


def train_state_from_numpy(cfg: ModelConfig, state, device=None):
    """The reference's train state ``{"params", "opt": OptState(m, v,
    step)}`` with numpy leaves -> the port's, on `device` (the card
    unless the caller names another): the parameters and both moments
    unstacked as ``params_from_numpy`` does, the step a 0-d int32
    tensor."""
    # imported here: optim.adamw imports models.pctx, and so this package,
    # so importing it at the top fails when optim is imported first
    from ..optim.adamw import OptState
    dev = resolve_device(device)
    opt = state["opt"]
    m, v, step = (opt.m, opt.v, opt.step) if hasattr(opt, "m") else (
        opt["m"], opt["v"], opt["step"])
    return {"params": params_from_numpy(cfg, state["params"], dev),
            "opt": OptState(m=params_from_numpy(cfg, m, dev),
                            v=params_from_numpy(cfg, v, dev),
                            step=torch.tensor(int(np.asarray(step)),
                                              dtype=torch.int32,
                                              device=dev))}
