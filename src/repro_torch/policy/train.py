"""Train a learned ``NodeScorer`` from parsed DecisionTraces (port of
``repro.policy.train``), and the model's serving side.

The model is deliberately small: a two-hidden-layer tanh MLP mapping
one candidate's 14 raw features (``pipeline.CANDIDATE_FEATURES``) to a
scalar score; a decision scores all candidates and a masked softmax
over the scores is the placement distribution.  Two training modes:

  * ``imitation``  — weighted cross-entropy against the logged
    (jiagu) chosen node, every decision weight 1;
  * ``offline-rl`` — the same loss under advantage-style reward
    weights (``dataset.reward_weights``): decisions followed by a QoS
    breach within the horizon, or which paid a cold-start scale-out,
    are down-weighted.

Optimization uses ``optim.adamw`` (warmup+cosine, global-norm clip,
decoupled decay — biases escape decay by name, and the ``mu`` / ``sd``
normalization stats live outside the trainable tree entirely).  The fit
is deterministic under a fixed config: numpy RNG for init and shuffling,
one fixed batch shape (the tail wrapped), f32 products (TF32 off), on
the card unless ``train(..., device="cpu")`` asks for the CPU.  The
returned policy is float32 numpy, exactly what ``PolicyStore.save``
persists and ``stage.LearnedScorer.swap`` serves.

Serving needs the rest: the forward pass on torch tensors (``forward``,
what ``stage.LearnedScorer`` runs on its device), the same forward in
numpy (``np_scores``) and top-1 agreement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .dataset import PolicyDataset, matrices, normalization, reward_weights

#: parameter keys updated by the optimizer ("bias*" escapes weight
#: decay by adamw's name rule; ``mu`` / ``sd`` are excluded entirely)
TRAINABLE_KEYS = ("w1", "bias1", "w2", "bias2", "w3", "bias3")


@dataclass
class TrainConfig:
    hidden: int = 32
    epochs: int = 10
    batch_size: int = 128
    lr: float = 0.01
    weight_decay: float = 1e-4
    seed: int = 0
    mode: str = "imitation"          # or "offline-rl"
    qos_penalty: float = 3.0         # offline-rl breach down-weight
    cold_penalty: float = 0.5        # offline-rl cold-start down-weight


def init_params(n_features: int, hidden: int, seed: int
                ) -> Dict[str, np.ndarray]:
    """Deterministic fan-in-scaled init (numpy RNG, not JAX keys — the
    policy store round-trips plain float32 arrays)."""
    rng = np.random.default_rng(seed)
    def w(shape):
        return rng.normal(0.0, 1.0 / math.sqrt(shape[0]),
                          shape).astype(np.float32)
    return {
        "w1": w((n_features, hidden)),
        "bias1": np.zeros(hidden, np.float32),
        "w2": w((hidden, hidden)),
        "bias2": np.zeros(hidden, np.float32),
        "w3": w((hidden, 1)),
        "bias3": np.zeros(1, np.float32),
    }


def forward(policy: Dict[str, torch.Tensor], x: torch.Tensor
            ) -> torch.Tensor:
    """Per-candidate scores of ``x`` ([..., F]) under ``policy`` (a dict
    of tensors on ``x``'s device).  The products run in full f32
    (``torch.matmul`` with TF32 off, PyTorch's default), so the scores
    stay within 1e-5 of ``np_scores``.

    Normalization is part of the policy — serving applies exactly the
    transform training fit, no separate scaler artifact."""
    z = (x - policy["mu"]) / policy["sd"]
    h = torch.tanh(torch.matmul(z, policy["w1"]) + policy["bias1"])
    h = torch.tanh(torch.matmul(h, policy["w2"]) + policy["bias2"])
    return (torch.matmul(h, policy["w3"]) + policy["bias3"])[..., 0]


def np_scores(policy: Dict[str, np.ndarray], x: np.ndarray) -> np.ndarray:
    """The same forward in numpy — lets evaluation and tests run
    without touching a device (argmax agreement is insensitive to the
    tiny tanh ULP differences between the two stacks)."""
    z = (x - policy["mu"]) / policy["sd"]
    h = np.tanh(z @ policy["w1"] + policy["bias1"])
    h = np.tanh(h @ policy["w2"] + policy["bias2"])
    return (h @ policy["w3"] + policy["bias3"])[..., 0]


def top1_agreement(policy: Dict[str, np.ndarray], X: np.ndarray,
                   mask: np.ndarray, y: np.ndarray) -> float:
    """Fraction of decisions whose argmax score picks the logged node."""
    if len(y) == 0:
        return 0.0
    s = np_scores(policy, X) - 1e9 * (1.0 - mask)
    return float((s.argmax(axis=-1) == y).mean())


def _loss(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
          xb, mb, yb, wb) -> torch.Tensor:
    """Weighted masked-softmax cross-entropy of one batch."""
    logits = forward({**params, **stats}, xb) + (mb - 1.0) * 1e9
    logz = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logz, -1, yb[:, None])[:, 0]
    return torch.sum(nll * wb) / torch.clamp(torch.sum(wb), min=1e-9)


def _step(params: Dict[str, torch.Tensor], opt, stats, acfg, xb, mb, yb,
          wb):
    """One optimizer step; the parameters are updated in place.
    Returns (new optimizer state, the batch's loss before the step)."""
    from ..optim import adamw
    leaves = [params[k] for k in params]
    with torch.enable_grad():
        loss = _loss(params, stats, xb, mb, yb, wb)
        grads = torch.autograd.grad(loss, leaves)
    _, opt, _ = adamw.update(params, dict(zip(params, grads)), opt, acfg)
    return opt, loss.detach()


def train(train_ds: PolicyDataset,
          holdout_ds: Optional[PolicyDataset] = None,
          cfg: Optional[TrainConfig] = None, device=None
          ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Fit the scorer on `device` (the card unless the caller names
    another); returns ``(policy, metrics)``.

    ``policy`` is a plain dict of float32 numpy arrays (weights +
    ``mu``/``sd``) — exactly what ``PolicyStore.save`` persists and
    ``stage.LearnedScorer.swap`` serves."""
    from ..core.predictor import resolve_device
    from ..optim import adamw

    cfg = cfg or TrainConfig()
    dev = resolve_device(device)
    if len(train_ds) == 0:
        raise ValueError("policy.train: empty training dataset")
    C = max(train_ds.max_candidates,
            holdout_ds.max_candidates if holdout_ds else 0, 1)
    X, mask, y = matrices(train_ds, n_candidates=C)
    if cfg.mode == "offline-rl":
        w = reward_weights(train_ds, qos_penalty=cfg.qos_penalty,
                           cold_penalty=cfg.cold_penalty)
    elif cfg.mode == "imitation":
        w = np.ones(len(X), np.float32)
    else:
        raise ValueError(f"policy.train: unknown mode {cfg.mode!r} "
                         f"(imitation | offline-rl)")
    mu, sd = normalization(X, mask)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    stats = {"mu": on(mu), "sd": on(sd)}
    params = {k: on(v).requires_grad_(True) for k, v in
              init_params(train_ds.n_features, cfg.hidden,
                          cfg.seed).items()}
    data = [on(X), on(mask), on(y.astype(np.int64)), on(w)]

    N = len(X)
    B = min(cfg.batch_size, N)
    steps_per_epoch = (N + B - 1) // B
    n_steps = max(cfg.epochs * steps_per_epoch, 1)
    acfg = adamw.AdamWConfig(
        lr=cfg.lr, weight_decay=cfg.weight_decay, clip_norm=1.0,
        warmup_steps=min(20, max(n_steps // 10, 1)),
        total_steps=n_steps, min_lr_frac=0.1)
    opt = adamw.init(params, acfg)

    rng = np.random.default_rng(cfg.seed)
    last_loss = float("nan")
    for _epoch in range(cfg.epochs):
        order = rng.permutation(N)
        for s0 in range(0, N, B):
            idx = order[s0:s0 + B]
            if len(idx) < B:           # fixed shapes: wrap the tail
                idx = np.concatenate([idx, order[:B - len(idx)]])
            rows = torch.from_numpy(idx).to(dev)
            opt, loss = _step(params, opt, stats, acfg,
                              *(a[rows] for a in data))
        last_loss = float(loss)

    policy = {k: v.detach().cpu().numpy().astype(np.float32)
              for k, v in params.items()}
    policy["mu"], policy["sd"] = mu, sd
    metrics = {
        "loss": last_loss,
        "mode_weight_mean": float(w.mean()),
        "n_train": float(N),
        "train_agreement": top1_agreement(policy, X, mask, y),
    }
    if holdout_ds is not None and len(holdout_ds):
        Xh, mh, yh = matrices(holdout_ds, n_candidates=C)
        metrics["n_holdout"] = float(len(yh))
        metrics["holdout_agreement"] = top1_agreement(policy, Xh, mh, yh)
    return policy, metrics


__all__ = ["TrainConfig", "TRAINABLE_KEYS", "init_params", "forward",
           "np_scores", "top1_agreement", "train"]
