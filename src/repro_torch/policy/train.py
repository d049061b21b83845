"""The learned ``NodeScorer``'s model, serving side.

The model is deliberately small: a two-hidden-layer tanh MLP mapping
one candidate's 14 raw features (``pipeline.CANDIDATE_FEATURES``) to a
scalar score; a decision scores all candidates and a masked softmax
over the scores is the placement distribution.

This module holds what serving and evaluation need: the deterministic
numpy init, the forward pass on torch tensors (``forward``, what
``stage.LearnedScorer`` runs on its device), the same forward in numpy
(``np_scores``) and top-1 agreement.  The fit itself (the reference's
``TrainConfig`` / ``train``: masked-softmax cross-entropy under
imitation or offline-RL weights, optimized with adamw) is not ported
yet; a policy trained by the reference, or any dict of float32 arrays
with the stored keys, serves here unchanged.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


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


__all__ = ["init_params", "forward", "np_scores", "top1_agreement"]
