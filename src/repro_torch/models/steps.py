"""Loss functions of the train step (port of ``repro.models.steps``).

The LM cross-entropy is computed *chunked over the sequence*: the
(B, S, V) logit tensor is never materialised.  Each chunk of c positions
computes its (B, c, V) logits in fp32, reduces them to a scalar and
drops them; under autograd each chunk runs in ``torch.utils.checkpoint``
(non-reentrant), so the backward recomputes its logits and only one
chunk's are alive at a time: at vocab 256,000 and c = 500, 512 MB rather
than S / c times that.

The reference's ``pctx.constrain`` sharding hints are the identity on
one device and are dropped; MoE is not in the port yet, so the auxiliary
loss is 0.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import InputShape, ModelConfig
from ..core.predictor import resolve_device
from .model import check_supported, final_hidden, logits_from_hidden

AUX_LOSS_WEIGHT = 0.01


def _pick_chunk(S: int, target: int = 512) -> int:
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def _chunk_xent(cfg: ModelConfig, params, h, targets, mask):
    logits = logits_from_hidden(cfg, params, h).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * mask)


def chunked_xent(cfg: ModelConfig, params, h, targets, mask=None,
                 chunk: int = 512):
    """h: (B, S, d) final hidden; targets: (B, S) int.
    Returns (total_loss, total_weight) as fp32 scalars."""
    B, S, _ = h.shape
    c = _pick_chunk(S, chunk)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    mask = mask.float()
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    weight = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled()
    for i in range(0, S, c):
        args = (cfg, params, h[:, i:i + c], targets[:, i:i + c],
                mask[:, i:i + c])
        part = (torch.utils.checkpoint.checkpoint(
            _chunk_xent, *args, use_reentrant=False) if remat
                else _chunk_xent(*args))
        loss = loss + part
        weight = weight + torch.sum(mask[:, i:i + c])
    return loss, weight


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = False,
            use_kernel: bool = True):
    """Mean next-token xent (+ MoE aux, 0 here). Returns (loss, metrics).
    `use_kernel` picks the hand-written kernels (and their backward) or
    the plain versions, as in ``models.model``."""
    h = final_hidden(cfg, params, batch, use_kernel=use_kernel, remat=remat)
    loss, weight = chunked_xent(cfg, params, h, batch["targets"],
                                batch.get("mask"))
    mean = loss / torch.clamp(weight, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    total = mean + AUX_LOSS_WEIGHT * aux
    return total, {"xent": mean, "aux": aux, "tokens": weight}


def make_train_batch(cfg: ModelConfig, shape: InputShape, rng=None,
                     device=None):
    """Concrete random batch (for smoke tests), numpy-drawn as the
    reference draws it, as int32 tensors on `device` (the card unless the
    caller names another)."""
    check_supported(cfg)
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    B, S = shape.global_batch, shape.seq_len
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    targets = rng.integers(0, cfg.vocab_size, (B, S))
    return {k: torch.from_numpy(a.astype(np.int32)).to(dev)
            for k, a in (("tokens", tokens), ("targets", targets))}
