"""Versioned on-disk policy storage: ``.npz`` weights + JSON header.

Layout under one root directory::

    policy_e000003.npz   # float32 arrays (w*/bias*/mu/sd) + __meta__
    latest.json          # {"epoch": 3, "file": "policy_e000003.npz", ...}

Every saved policy is tagged with the *serving epoch* it was trained
for — the PredictionService forest epoch at save time — which is what
makes hot-swap race-free: the platform's retrain listener reloads the
store and re-tags the scorer in the same synchronous callback that
bumped the service epoch, so a scorer can always check "am I serving
the epoch the world is at?" (``stage.ScorerStats.stale_serves``).

``POLICY_SCHEMA`` versions the file format itself (array names + meta
keys); loading a newer schema than this reader speaks raises instead
of mis-deserializing.  Numpy-only — no JAX at store time.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: .npz layout version (bump on array-name / meta-key changes)
POLICY_SCHEMA = 1

#: arrays every stored policy must carry
REQUIRED_KEYS = ("w1", "bias1", "w2", "bias2", "w3", "bias3",
                 "mu", "sd")


class PolicyStoreError(ValueError):
    """A policy artifact failed schema validation."""


class PolicyStore:
    """Epoch-tagged save/load of learned-scorer weights."""

    def __init__(self, root: str):
        self.root = root

    # -- paths ------------------------------------------------------------

    def _path(self, epoch: int) -> str:
        return os.path.join(self.root, f"policy_e{epoch:06d}.npz")

    def _latest_path(self) -> str:
        return os.path.join(self.root, "latest.json")

    def epochs(self) -> List[int]:
        """Stored epochs, ascending (empty when the root is missing)."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if name.startswith("policy_e") and name.endswith(".npz"):
                try:
                    out.append(int(name[len("policy_e"):-len(".npz")]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_epoch(self) -> Optional[int]:
        eps = self.epochs()
        return eps[-1] if eps else None

    # -- save / load ------------------------------------------------------

    def save(self, policy: Dict[str, np.ndarray], *, epoch: int,
             mode: str = "imitation",
             feature_names: Sequence[str] = (),
             metrics: Optional[Dict[str, float]] = None) -> str:
        """Persist one policy tagged with its serving ``epoch``."""
        missing = [k for k in REQUIRED_KEYS if k not in policy]
        if missing:
            raise PolicyStoreError(
                f"policy is missing arrays {missing} "
                f"(required: {list(REQUIRED_KEYS)})")
        os.makedirs(self.root, exist_ok=True)
        meta = {
            "schema": POLICY_SCHEMA,
            "epoch": int(epoch),
            "mode": mode,
            "feature_names": list(feature_names),
            "n_features": int(policy["w1"].shape[0]),
            "hidden": int(policy["w1"].shape[1]),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        path = self._path(epoch)
        arrays = {k: np.asarray(v, np.float32) for k, v in policy.items()}
        np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)
        with open(self._latest_path(), "w") as fh:
            json.dump({"schema": POLICY_SCHEMA, "epoch": int(epoch),
                       "file": os.path.basename(path), "mode": mode},
                      fh, indent=1)
        return path

    def load(self, epoch: Optional[int] = None
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Load ``(policy, meta)`` — the latest epoch by default, or a
        pinned one.  Raises ``FileNotFoundError`` on an empty store and
        ``PolicyStoreError`` on schema/layout mismatches."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(
                    f"policy store {self.root!r} holds no policies")
        path = self._path(epoch)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"policy store {self.root!r} has no epoch {epoch} "
                f"(stored: {self.epochs()})")
        with np.load(path) as npz:
            if "__meta__" not in npz:
                raise PolicyStoreError(f"{path}: missing __meta__ header")
            meta = json.loads(str(npz["__meta__"]))
            if meta.get("schema", 0) > POLICY_SCHEMA:
                raise PolicyStoreError(
                    f"{path}: schema v{meta.get('schema')} is newer than "
                    f"this reader (v{POLICY_SCHEMA})")
            policy = {k: np.asarray(npz[k]) for k in npz.files
                      if k != "__meta__"}
        missing = [k for k in REQUIRED_KEYS if k not in policy]
        if missing:
            raise PolicyStoreError(f"{path}: missing arrays {missing}")
        return policy, meta


__all__ = ["POLICY_SCHEMA", "REQUIRED_KEYS", "PolicyStore",
           "PolicyStoreError"]
