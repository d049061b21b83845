"""Step-atomic checkpoints (port of ``repro.checkpoint.checkpoint``).

Layout:  <dir>/step_000123/  arrays.npz  meta.json
Writes go to ``<dir>/.tmp_<step>`` and are *renamed* into place — a crash
mid-write never corrupts the latest checkpoint (fault tolerance).  Keep-K
GC deletes the oldest checkpoints after a successful save.

Flat keys are built as the reference builds them: dict keys, list
indices and NamedTuple fields joined by ``/`` (``opt/m/layers/0/...``).
numpy has no bf16, so bf16 leaves are stored as f32 (exactly) and cast
back on restore.  ``restore`` takes a state of the same structure as its
template (``like_state``), checks every leaf's shape and dtype against
it, and puts each leaf on `device`: the card unless the caller names
another.  A train state's held bf16 working copies (``state["held"]``,
``distributed.steps.make_train_step``) are its parameters' casts: they
are neither saved nor restored, and the step makes them anew from the
restored parameters.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..core.predictor import resolve_device


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):           # NamedTuple: by field name
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflat(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _unflat(v, flat, key(k)) for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_unflat(v, flat, key(f))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflat(v, flat, key(i)) for i, v in enumerate(like))
    return flat[prefix]


def _saved(state):
    """`state` without its held working copies."""
    if isinstance(state, dict) and "held" in state:
        return {k: v for k, v in state.items() if k != "held"}
    return state


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def save(ckpt_dir: str, step: int, state, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: _to_numpy(v) for k, v in _flat(_saved(state)).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "n_arrays": len(arrays), **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and os.path.exists(
                       os.path.join(ckpt_dir, d, "meta.json")))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, like_state, device=None,
            step: Optional[int] = None):
    """-> (state, meta): the checkpoint of `step` (the latest when None)
    in `like_state`'s structure (without held working copies), each leaf
    of its template's shape and dtype, on `device`."""
    like_state = _saved(like_state)
    dev = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    rebuilt = {}
    with np.load(os.path.join(d, "arrays.npz")) as npz:
        for key, like in _flat(like_state).items():
            if key not in npz:
                raise KeyError(f"{key} is not in the checkpoint of step "
                               f"{step}")
            arr = npz[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(like.shape)}")
            stored = torch.float32 if like.dtype == torch.bfloat16 \
                else like.dtype
            if torch.from_numpy(np.empty(0, arr.dtype)).dtype != stored:
                raise TypeError(f"{key}: checkpoint dtype {arr.dtype}, "
                                f"expected {like.dtype}")
            rebuilt[key] = torch.from_numpy(np.array(arr)).to(
                device=dev, dtype=like.dtype)
    return _unflat(like_state, rebuilt), meta
