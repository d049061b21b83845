"""End-to-end training driver, the port's twin of ``examples/train_lm.py``:
train a ~100M-parameter gemma2-family LM on the repository's own source
code (byte-level) for a few hundred steps with checkpointing and fault
tolerance, on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] \\
      [--tiny] [--ckpt-dir DIR] [--batch B] [--seq S] [--device cpu]

The model is gemma2-2b with 10 layers of width 768, 8 query heads over 4
kv heads of 96, d_ff 3,072, a byte vocabulary of 256 and a window of
512, in f32, at B 8, S 512; it keeps gemma2's softcaps (50 on the
attention scores, 30 on the logits), so its attention runs on the f32
3xTF32 kernels at head dim 96 with a softcap, forward and backward.
``--tiny`` shrinks it to 2 layers of 128 (4 heads over 2 of 32, d_ff
512, window 128, B 8, S 256).  AdamW at lr 6e-4 with a warmup of a
twentieth of the steps; a checkpoint every 50 steps, so an interrupted
run resumes when the same command is run again.

A single rank trains on one device (no mesh, as the example's one-device
mesh); under ``torchrun`` ``launch.train``'s process group and (n, 1)
("data", "model") mesh over the ranks.  Without ``--device`` it trains on
the card and raises where there is none.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

#: the example's checkpoints, under the temporary directory
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def config(tiny: bool = False):
    """The example's model: gemma2-2b cut to ~100M parameters (or ~1M with
    `tiny`), byte vocabulary, f32."""
    from ..configs.base import get_config
    base = get_config("gemma2-2b")
    if tiny:
        return base.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, d_ff=512, vocab_size=256,
                            window=128, dtype="float32")
    # byte vocab keeps the embedding small so the budget goes to the blocks
    return base.replace(n_layers=10, d_model=768, n_heads=8, n_kv_heads=4,
                        head_dim=96, d_ff=3072, vocab_size=256, window=512,
                        dtype="float32")


def shape_of(tiny: bool, batch: int = 0, seq: int = 0):
    """The example's InputShape: B 8 and S 512 (256 with `tiny`) unless
    given."""
    from ..configs.base import InputShape
    return InputShape("train_lm", seq or (256 if tiny else 512),
                      batch or 8, "train")


def opt_config(steps: int):
    """The example's AdamW: lr 6e-4, cosine over `steps`, warmup of a
    twentieth of them."""
    from ..optim.adamw import AdamWConfig
    return AdamWConfig(lr=6e-4, total_steps=steps,
                       warmup_steps=max(steps // 20, 1))


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, save_every: int = 50, times=None):
    """Train as the example does from parsed `args`, printing its lines;
    returns (state, the losses of the steps this run took).  `save_every`
    and `times` go to ``train_loop`` (a caller may checkpoint more often,
    or collect each step's seconds)."""
    import torch
    from .train import _mesh_from_env, train_loop
    cfg = config(args.tiny)
    mesh = _mesh_from_env(args.device, False)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    if rank0:
        print(f"model: {cfg.n_layers}L d={cfg.d_model} "
              f"params={cfg.param_count() / 1e6:.1f}M")
    state, losses = train_loop(
        cfg, shape_of(args.tiny, args.batch, args.seq), mesh,
        steps=args.steps, ckpt_dir=args.ckpt_dir, resume=True,
        save_every=save_every, log_every=10, data="bytes",
        opt_cfg=opt_config(args.steps), device=args.device, times=times)
    if rank0 and losses:
        print(f"done. loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(ckpts in {args.ckpt_dir})")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return state, losses


def main(argv: Optional[Sequence[str]] = None):
    run(parse(argv))


if __name__ == "__main__":
    main()
