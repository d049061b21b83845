"""The train step on one device (port of the one-device part of
``repro.distributed.steps``).

``make_train_step`` returns a :class:`StepBundle` whose ``fn(state,
batch) -> (state, metrics)`` does the reference's step: the loss and its
gradients (``torch.autograd.grad`` over the parameter leaves; with
``microbatch`` > 1 the batch is split on its leading axis and the
gradients summed in f32 and divided by ``microbatch``), then
``optim.adamw.update``.  The state is ``{"params", "opt"}`` as in the
reference; the parameters and moments are updated in place (AdamW's
note).  Metrics: ``loss``, ``xent``, ``aux``, ``tokens``, ``grad_norm``,
``lr``, as 0-d tensors on the device.

PyTorch runs eagerly, so there is nothing to jit or to lower; the mesh,
the sharding rules and ``cast_params`` wait for the ``DeviceMesh`` slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..configs.base import InputShape, ModelConfig
from ..core.predictor import resolve_device
from ..models import steps as steps_lib
from ..optim import adamw


@dataclass
class StepBundle:
    name: str
    fn: Callable            # the step
    meta: dict = field(default_factory=dict)


def make_train_step(cfg: ModelConfig, shape: InputShape,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    remat: bool = True, microbatch: int = 1,
                    device=None) -> StepBundle:
    """The train step of `cfg` at `shape` on `device` (the card unless the
    caller names another), through the hand-written kernels and their
    backward kernels."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    dev = resolve_device(device)
    if microbatch < 1 or shape.global_batch % microbatch:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{microbatch} microbatches")

    def grads_of(leaves, params, b):
        with torch.enable_grad():
            loss, mets = steps_lib.loss_fn(cfg, params, b, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, grads

    def step(state, batch):
        params = state["params"]
        leaves = [p.requires_grad_(True) for _, p in
                  adamw.leaves_with_path(params)]
        if microbatch > 1:
            parts = [{k: v.chunk(microbatch, dim=0)[i]
                      for k, v in batch.items()} for i in range(microbatch)]
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for b in parts:
                l_i, metrics, g = grads_of(leaves, params, b)
                for acc, gi in zip(g_acc, g):
                    acc.add_(gi)
                loss = loss + l_i
                del g
            grads = [acc.div_(microbatch) for acc in g_acc]
            loss = loss / microbatch
        else:
            loss, metrics, grads = grads_of(leaves, params, batch)
        grads = _like(params, iter(grads))
        _, new_opt, opt_metrics = adamw.update(params, grads, state["opt"],
                                               opt_cfg)
        del grads
        return ({"params": params, "opt": new_opt},
                {**metrics, **opt_metrics, "loss": loss})

    return StepBundle("train", step,
                      meta={"remat": remat, "microbatch": microbatch,
                            "device": dev})


def _like(tree, it):
    """`tree`'s structure with its leaves taken from `it` in order."""
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_like(v, it) for v in tree]
    return next(it)
