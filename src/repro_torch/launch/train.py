"""End-to-end training driver with fault tolerance (port of
``repro.launch.train``): on one device (the card unless asked for the
CPU), or on a ``DeviceMesh`` over the ranks of a process group.

Deterministic data pipeline, step-atomic checkpoints (resume with
``--resume``), straggler logging, watchdog heartbeats, optional failure
injection (``--fail-at N`` kills the loop at step N; rerunning with
``--resume`` restores from the latest checkpoint: the fault-tolerance
drill).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --smoke --steps 10 --device cpu

Under ``torchrun`` (more than one rank) ``main`` starts the process group
(NCCL on the card, gloo with ``--device cpu``) and trains on an (n, 1)
("data", "model") mesh over the ranks, or on the 16x16 production mesh
with ``--production-mesh`` (256 ranks):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --smoke --steps 10 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_state(cfg, opt_cfg, seed: int = 0, device=None,
                param_dtype=torch.float32):
    """A fresh train state on `device`: parameters of `param_dtype` (the
    router's stay f32) from the port's ``init_params`` drawn from a
    generator seeded `seed` on that device, zero AdamW moments of
    ``opt_cfg.moment_dtype``."""
    from ..core.predictor import resolve_device
    from ..models import model as model_lib
    from ..optim import adamw
    dev = resolve_device(device)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev,
        param_dtype=param_dtype)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def put_batch(batch, device, shardings=None, mesh=None):
    """A numpy batch on `device`; with `shardings` (the bundle's
    ``meta["batch_shardings"]``) as DTensors on `mesh`, each rank keeping
    its slice."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    if shardings is None:
        return out
    from ..distributed.steps import distribute
    return distribute(out, shardings, mesh)


def _gathered(state):
    """A state of DTensors as plain tensors holding the global values."""
    from ..distributed.steps import _full, _map2
    return _map2(lambda t, _s: _full(t), state, state)


def train_loop(cfg, shape, mesh=None, steps: int = 100, ckpt_dir=None,
               resume=False, save_every: int = 0, log_every: int = 10,
               fail_at: int = -1, microbatch: int = 1, remat: bool = True,
               seed: int = 0, data: str = "synthetic", opt_cfg=None,
               quiet=False, device=None):
    """The reference's loop: a checkpoint every `save_every` steps,
    ``inj.maybe_fail(i)`` after saving, a final save; `resume` restores
    the latest checkpoint.  Returns (state, the steps' losses).

    `mesh=None`: one device, `device`.  With a mesh the state is built
    whole on each rank from the same seed and distributed into the
    bundle's shardings (``distribute_tensor``, each rank keeping its
    shards), batches likewise, and the mesh step runs; checkpoints hold
    the gathered global state, written by rank 0."""
    from .. import checkpoint as ckpt_lib
    from ..core.predictor import resolve_device
    from ..data.pipeline import ByteCorpus, TokenPipeline
    from ..distributed.fault_tolerance import (FailureInjector,
                                               StragglerDetector, Watchdog)
    from ..distributed.steps import make_train_step
    from ..optim import adamw

    from ..distributed.steps import distribute

    dev = (torch.device(mesh.device_type) if mesh is not None
           else resolve_device(device))
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=max(steps, 2),
                                           warmup_steps=max(steps // 20, 1))
    bundle = make_train_step(cfg, mesh, shape, opt_cfg=opt_cfg, remat=remat,
                             microbatch=microbatch, device=dev)
    batch_sh = bundle.meta["batch_shardings"]
    writer = mesh is None or torch.distributed.get_rank() == 0

    start_step = 0
    state = build_state(cfg, opt_cfg, seed, dev)
    if resume and ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
        # the fresh state is the template of shapes and dtypes
        state, meta = ckpt_lib.restore(ckpt_dir, state, dev)
        start_step = meta["step"]
        if not quiet:
            print(f"[train] resumed from step {start_step}")
    if mesh is not None:
        state = distribute(state, bundle.meta["state_shardings"], mesh)

    def save(step, **meta):
        whole = _gathered(state) if mesh is not None else state
        if writer:
            ckpt_lib.save(ckpt_dir, step, whole, extra_meta=meta)
        if mesh is not None:
            torch.distributed.barrier()

    if data == "bytes":
        corpus = ByteCorpus()
        def get_batch(i):
            return corpus.batch(i, shape.global_batch, shape.seq_len)
    else:
        pipe = TokenPipeline(cfg, shape, seed=seed)
        get_batch = pipe.batch

    wd = Watchdog(timeout_s=600)
    sd = StragglerDetector()
    inj = FailureInjector(fail_at_step=fail_at)
    history = []
    for i in range(start_step, steps):
        t0 = time.time()
        batch = put_batch(get_batch(i), dev, batch_sh, mesh)
        state, metrics = bundle.fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        wd.beat(i)
        sd.record(0, dt)
        history.append(loss)
        if not quiet and writer and (i % log_every == 0 or i == steps - 1):
            print(f"[train] step {i} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if ckpt_dir and save_every and (i + 1) % save_every == 0:
            save(i + 1, arch=cfg.name, loss=loss)
        inj.maybe_fail(i)  # after ckpt: the drill resumes past this step
    if ckpt_dir and save_every:
        save(steps, arch=cfg.name, loss=history[-1] if history else None)
    return state, history


def main():
    from ..configs.base import InputShape, get_config, get_smoke_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "bytes"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    shape = InputShape("custom", args.seq, args.batch, "train")
    mesh = _mesh_from_env(args.device, args.production_mesh)
    t0 = time.time()
    _state, history = train_loop(
        cfg, shape, mesh, args.steps, ckpt_dir=args.ckpt_dir,
        resume=args.resume, save_every=args.save_every,
        log_every=args.log_every, fail_at=args.fail_at,
        microbatch=args.microbatch, data=args.data, seed=args.seed,
        device=args.device)
    if mesh is None or torch.distributed.get_rank() == 0:
        print(f"[train] done: {len(history)} steps in "
              f"{time.time()-t0:.1f}s; loss {history[0]:.4f} -> "
              f"{history[-1]:.4f}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


def _mesh_from_env(device, production: bool):
    """The mesh of a ``torchrun`` launch: None for a single rank without
    ``--production-mesh``; else the process group started from torchrun's
    environment (NCCL on the card, gloo on the CPU) and an (n, 1) mesh
    over its ranks, or the 16x16 production mesh."""
    import os
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n == 1 and not production:
        return None
    import torch.distributed as dist
    from .mesh import make_production_mesh
    dev_type = torch.device(device or "cuda").type
    if dev_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo")
    if production:
        return make_production_mesh(device_type=dev_type)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev_type, (n, 1),
                            mesh_dim_names=("data", "model"))


if __name__ == "__main__":
    main()
