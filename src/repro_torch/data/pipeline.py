"""Deterministic data pipeline (a copy of ``repro.data.pipeline``: numpy
only, so batches equal the reference's array for array).

Batches are a pure function of (seed, step) via counter-based Philox
bit-generators, so the pipeline is *stateless*: resuming from a checkpoint
needs only the step number (no iterator state to snapshot), and every
data-parallel host can materialize exactly its shard.  Two sources:

  * ``TokenPipeline`` — synthetic LM tokens with a Zipfian unigram mixture
    plus short Markov motifs (so a model can actually reduce loss on it).
  * ``ByteCorpus``   — byte-level LM over a real text file (the repo's own
    sources by default): overlapping windows, deterministic shuffling.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..configs.base import InputShape, ModelConfig


def _rng(seed: int, step: int, salt: int = 0) -> np.random.Generator:
    # counter-based: batches are a pure function of (seed, step, salt)
    return np.random.Generator(
        np.random.Philox(key=(seed << 32) ^ (salt & 0xFFFFFFFF),
                         counter=step))


class TokenPipeline:
    """Synthetic-but-learnable token stream."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, seed: int = 0,
                 n_motifs: int = 64, motif_len: int = 8):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        v = cfg.vocab_size
        motif_rng = _rng(seed, 0, salt=999)
        self.motifs = motif_rng.integers(0, v, (n_motifs, motif_len))
        # Zipf-ish unigram distribution over a capped head of the vocab
        head = min(v, 4096)
        w = 1.0 / np.arange(1, head + 1) ** 1.1
        self.head = head
        self.p = w / w.sum()

    def _tokens(self, rng, B: int, S: int) -> np.ndarray:
        toks = rng.choice(self.head, p=self.p, size=(B, S + 1))
        # paste motifs at random offsets (repeatable structure => learnable)
        n_paste = max(1, (S // 64))
        for b in range(B):
            idx = rng.integers(0, len(self.motifs), n_paste)
            offs = rng.integers(0, S + 1 - self.motifs.shape[1], n_paste)
            for i, o in zip(idx, offs):
                toks[b, o: o + self.motifs.shape[1]] = self.motifs[i]
        return toks.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for `step` (numpy, host-resident)."""
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        rng = _rng(self.seed, step)
        out: Dict[str, np.ndarray] = {}
        if cfg.frontend == "audio":
            out["frames"] = rng.standard_normal(
                (B, S, cfg.frontend_dim)).astype(np.float32)
            out["targets"] = rng.integers(0, cfg.vocab_size,
                                          (B, S)).astype(np.int32)
            return out
        if cfg.frontend == "vision":
            nf = cfg.n_frontend_tokens
            toks = self._tokens(rng, B, S - nf)
            out["patch_embeds"] = rng.standard_normal(
                (B, nf, cfg.frontend_dim)).astype(np.float32)
            out["tokens"] = toks[:, :-1]
            out["targets"] = toks[:, 1:]
            return out
        toks = self._tokens(rng, B, S)
        out["tokens"] = toks[:, :-1]
        out["targets"] = toks[:, 1:]
        return out

    def shard_batch(self, step: int, lo: int, hi: int):
        """Rows [lo, hi) of the global batch — what one DP host loads.
        Deterministic: materializes the global batch row-block only."""
        full = self.batch(step)
        return {k: v[lo:hi] for k, v in full.items()}


class ByteCorpus:
    """Byte-level LM windows over a text file tree."""

    def __init__(self, root: str = ".", exts=(".py", ".md"),
                 max_bytes: int = 8 << 20, seed: int = 0):
        bufs = []
        total = 0
        for dirpath, _dirs, files in sorted(os.walk(root)):
            if any(part.startswith(".") or part == "__pycache__"
                   for part in dirpath.split(os.sep)):
                continue
            for fn in sorted(files):
                if not fn.endswith(exts):
                    continue
                try:
                    with open(os.path.join(dirpath, fn), "rb") as f:
                        bufs.append(f.read())
                except OSError:
                    continue
                total += len(bufs[-1])
                if total >= max_bytes:
                    break
            if total >= max_bytes:
                break
        data = b"\n".join(bufs) if bufs else b"empty corpus"
        self.data = np.frombuffer(data, np.uint8)
        self.seed = seed

    def batch(self, step: int, B: int, S: int) -> Dict[str, np.ndarray]:
        rng = _rng(self.seed, step, salt=7)
        n = len(self.data) - (S + 1)
        starts = rng.integers(0, max(n, 1), B)
        rows = np.stack([self.data[s: s + S + 1] for s in starts])
        rows = rows.astype(np.int32)
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
