"""Loss functions of the train step (port of ``repro.models.steps``).

The LM cross-entropy is computed *chunked over the sequence*: the
(B, S, V) logit tensor is never materialised.  Each chunk of c positions
computes its (B, c, V) logits in fp32, reduces them to a scalar and
drops them; under autograd each chunk runs in ``torch.utils.checkpoint``
(non-reentrant), so the backward recomputes its logits and only one
chunk's are alive at a time: at vocab 256,000 and c = 500, 512 MB rather
than S / c times that.

The reference's ``pctx.constrain`` sharding hints are the identity on
one device and are dropped.  MoE layers add their load-balance loss,
weighted by AUX_LOSS_WEIGHT, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import InputShape, ModelConfig
from ..core.predictor import resolve_device
from .model import final_hidden, logits_from_hidden

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
            use_kernel: bool = True, dispatch: Optional[str] = None):
    """Mean next-token xent (+ MoE aux). Returns (loss, metrics).
    `use_kernel` picks the hand-written kernels (and their backward) or
    the plain versions, as in ``models.model``."""
    h, aux = final_hidden(cfg, params, batch, use_kernel=use_kernel,
                          remat=remat, dispatch=dispatch)
    targets = batch["targets"]
    if cfg.frontend == "vision":
        # frontend tokens carry no LM targets
        h = h[:, h.shape[1] - targets.shape[1]:]
    loss, weight = chunked_xent(cfg, params, h, targets, batch.get("mask"))
    mean = loss / torch.clamp(weight, min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    total = mean + AUX_LOSS_WEIGHT * aux
    return total, {"xent": mean, "aux": aux, "tokens": weight}


def make_train_batch(cfg: ModelConfig, shape: InputShape, rng=None,
                     device=None):
    """Concrete random batch (for smoke tests), numpy-drawn as the
    reference draws it, on `device` (the card unless the caller names
    another): tokens and targets int32, a frontend's frames or patch
    embeddings f32."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((B, S, cfg.frontend_dim),
                                              dtype=np.float32)
        batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S))
    elif cfg.frontend == "vision":
        n_front = cfg.n_frontend_tokens
        batch["patch_embeds"] = rng.standard_normal(
            (B, n_front, cfg.frontend_dim), dtype=np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - n_front))
        batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S - n_front))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
        batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S))
    return {k: torch.from_numpy(a if a.dtype == np.float32
                                else a.astype(np.int32)).to(dev)
            for k, a in batch.items()}
