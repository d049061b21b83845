"""Loss functions of the train step (port of ``repro.models.steps``).

The LM cross-entropy is computed *chunked over the sequence*: the
(B, S, V) logit tensor is never materialised.  Each chunk of c positions
computes its (B, c, V) logits in fp32, reduces them to a scalar and
drops them; under autograd each chunk runs in ``torch.utils.checkpoint``
(non-reentrant), so the backward recomputes its logits and only one
chunk's are alive at a time: at vocab 256,000 and c = 500, 512 MB rather
than S / c times that.

On DTensors each chunk runs on each rank's shards
(``_chunk_xent_shards``): its rows, and its slice of the vocabulary as
the reference's "logits" hint splits it.  The target's logit is picked
by a masked sum over the slice, the reference's one-hot mask-reduce, and
the max and sums over the split vocabulary are (B, c) all-reduces; on
plain tensors by ``gather``.  Both are exact.  MoE layers add their
load-balance loss, weighted by AUX_LOSS_WEIGHT, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import InputShape, ModelConfig
from ..core.predictor import resolve_device
from . import pctx
from .model import final_hidden, logits_from_hidden

AUX_LOSS_WEIGHT = 0.01


def _pick_chunk(S: int, target: int = 512) -> int:
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def _chunk_xent(cfg: ModelConfig, params, h, targets, mask):
    h = pctx.constrain(h, "activations")
    if pctx.is_dtensor(h):
        return _chunk_xent_shards(cfg, params, h, targets, mask)
    logits = logits_from_hidden(cfg, params, h).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * mask)


def _chunk_xent_shards(cfg: ModelConfig, params, h, targets, mask):
    """``_chunk_xent`` of DTensor `h` on each rank's shards
    (``pctx.local_call``): its rows and its slice of the vocabulary as
    the "logits" hint places them (the table sliced to match); the max
    and the two sums over a split vocabulary all-reduced over its axis,
    (B, c) each, the reference's one-hot mask-reduce; the chunk's sum a
    partial sum over the rows' axes."""
    from ..distributed.sharding import axis_size
    key = "lm_head" if "lm_head" in params else "embed"
    table = params[key]["table"]
    mesh = h.device_mesh
    rows, _, vent = pctx.spec_of("logits", 3)
    if pctx.hint("logits") is None:
        rows, vent = pctx.activation_rows(3)[0], None
    if not isinstance(vent, str) or axis_size(mesh, vent) == 1:
        vent = None                     # the whole vocabulary on each rank
    v0 = pctx.axes_rank(mesh, vent) * (table.shape[0] //
                                       axis_size(mesh, vent)) if vent else 0

    def local(h, table, targets, mask):
        # the table under both names: logits_from_hidden reads "embed"
        logits = logits_from_hidden(
            cfg, {"embed": {"table": table}, key: {"table": table}},
            h).float()
        m = torch.amax(logits, dim=-1).detach()
        if vent:
            m = pctx.max_over(m, mesh, vent)
        s = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        vocab = v0 + torch.arange(logits.shape[-1], device=logits.device)
        hit = vocab == targets.long()[..., None]
        ll = torch.sum(torch.where(hit, logits, torch.zeros_like(logits)),
                       dim=-1)
        if vent:
            s, ll = pctx.sum_over(torch.stack([s, ll]), mesh, vent).unbind(0)
        return torch.sum((m + torch.log(s) - ll) * mask)
    r2 = (rows, None)
    return pctx.local_call(local, (h, table, targets, mask),
                           ((rows, None, None), (vent, None), r2, r2), (),
                           partial=pctx.axes_of(rows))


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
