"""Multi-pod dry run: prove the distribution config is coherent (port of
``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell this traces the
cell's step (train / prefill / decode) on the production mesh — 16x16
single-pod and 2x16x16 multi-pod — without a device and without
allocating: one process joins a ``fake`` process group of world size 256
or 512 (``torch.testing._internal.distributed.fake_pg.FakeStore``),
builds the mesh on "cpu", and runs the step under ``FakeTensorMode`` on
the bundle's abstract DTensor arguments.  PyTorch compiles nothing, so
where the reference lowers and compiles the step and reads XLA's
analyses, the port records what ``roofline.TraceCounter`` counts on the
traced step:

  * the per-device argument bytes from the specs' shard shapes,
  * FLOPs / bytes for the roofline,
  * the collective schedule (wire bytes per collective kind),
  * the three roofline terms + bottleneck (launch/roofline.py).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
      --mesh single [--out benchmarks/artifacts/dryrun_torch] [--set ...]
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fake_world(world_size: int):
    """The default process group as a ``fake`` one of `world_size` ranks
    (this process rank 0), started anew unless it already is one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and \
                dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running: the dry "
                               "run needs a fake one of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(kind: str):
    from .mesh import make_production_mesh
    multi = kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device_type="cpu")


def _per_device_arg_bytes(args) -> int:
    from ..models.pctx import is_dtensor
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            total += t.numel() * t.element_size()
    walk(args)
    return total


def _hint_opts(kw: dict, mesh, shape) -> None:
    """The reference's perf-iteration flags as builder kwargs."""
    from ..distributed.sharding import NamedSharding, P, dp_entry
    from ..distributed.steps import moe_dshard_hints
    if kw.pop("act_seq_shard", None):
        # Megatron-style sequence parallelism for the residual stream
        dpx = dp_entry(mesh, shape.global_batch)
        kw.setdefault("extra_hints", {})["activations"] = NamedSharding(
            mesh, P(dpx, "model", None))
    if kw.pop("moe_dshard", None):
        # decode: keep expert weights sharded; shard expert-buffer d dim on
        # "data" so the FFN contraction partial-sums + all-reduces
        # activations instead of all-gathering expert weights.  Each rank
        # routes every group on the whole width, multiplies its d slice of
        # the buffers by its stored shard of the weights and all-reduces
        # the gate and up products over "data" (models.moe._moe_shards); a
        # cell without MoE ignores the hint
        kw.setdefault("extra_hints", {}).update(moe_dshard_hints(mesh))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             opts: dict | None = None, *, mesh=None, cfg=None) -> dict:
    """One cell's record.  `mesh` defaults to the production mesh of
    `mesh_kind` on a fake process group; `cfg` to ``get_config(arch)``
    (a test passes a smoke config and a small fake mesh)."""
    from ..configs.base import SHAPE_BY_NAME, cell_is_runnable, get_config
    from ..distributed.steps import fake_mode, make_step_bundle
    from ..optim.adamw import AdamWConfig
    from .roofline import TraceCounter, roofline_terms

    cfg = cfg or get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "kind": shape.kind, "opts": opts or {}}
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    mesh = mesh if mesh is not None else _mesh(mesh_kind)
    kw = dict(opts or {})
    _hint_opts(kw, mesh, shape)
    if kw.get("cache_l_model") is not None:
        kw["cache_l_model"] = bool(kw["cache_l_model"])
    if isinstance(kw.get("param_dtype"), str):
        kw["param_dtype"] = _DTYPES[kw["param_dtype"]]
    # big-model dry-runs default to bf16 Adam moments
    if shape.kind == "train":
        kw.setdefault("opt_cfg", AdamWConfig(
            moment_dtype=kw.pop("moment_dtype", "bfloat16")))
        if "cast_params" in kw:
            kw["cast_params"] = bool(kw["cast_params"])
    else:
        kw.pop("cast_params", None)
    if shape.kind != "decode":
        kw.pop("cache_l_model", None)
    t0 = time.time()
    bundle = make_step_bundle(cfg, mesh, shape, **kw)
    t_build = time.time() - t0
    fm = fake_mode()
    t0 = time.time()
    with fm, TraceCounter(fm) as tc:
        bundle.fn(*bundle.args)
    t_trace = time.time() - t0

    coll = tc.collectives()
    stats = tc.stats()
    terms = roofline_terms(stats, coll, mesh.size(), cfg, shape)
    rec.update({
        "status": "ok",
        "step": bundle.name,
        "dispatch": bundle.meta.get("dispatch"),
        "lower_s": round(t_build, 2),
        "trace_s": round(t_trace, 2),
        "memory": {"arg_bytes_analytic_per_device":
                   _per_device_arg_bytes(bundle.args)},
        "cost": stats,
        "collectives": coll,
        "roofline": terms,
    })
    return rec


def main() -> int:
    from ..configs.base import SHAPES, list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="benchmarks/artifacts/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--remat", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--dispatch", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="extra builder opts, e.g. --set cast_params=1 "
                         "--set param_dtype=bfloat16 --set act_seq_shard=1")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s.name) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    opts = {}
    if args.remat is not None:
        opts["remat"] = bool(args.remat)
    if args.microbatch is not None:
        opts["microbatch"] = args.microbatch
    if args.dispatch is not None:
        opts["dispatch"] = args.dispatch
    for kv in args.set:
        k, _, v = kv.partition("=")
        opts[k] = int(v) if v.isdigit() else v

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mesh_kind in meshes:
            name = f"{args.tag}--{arch}--{shape}--{mesh_kind}.json"
            path = os.path.join(args.out, name)
            if os.path.exists(path) and not args.force:
                print(f"[skip-cached] {name}")
                continue
            t0 = time.time()
            try:
                # train-only opts must not leak into serve cells
                cell_kind = next(s.kind for s in SHAPES
                                 if s.name == shape)
                kw = dict(opts)
                if cell_kind != "train":
                    kw.pop("remat", None)
                    kw.pop("microbatch", None)
                rec = run_cell(arch, shape, mesh_kind, kw)
            except Exception:
                rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "status": "error",
                       "error": traceback.format_exc(limit=20)}
                failures += 1
            rec["wall_s"] = round(time.time() - t0, 2)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            status = rec.get("status")
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f" bottleneck={r['bottleneck']}"
                         f" comp={r['compute_s']:.3e}s"
                         f" mem={r['memory_s']:.3e}s"
                         f" coll={r['collective_s']:.3e}s"
                         f" trace={rec['trace_s']:.0f}s")
            elif status == "skipped":
                extra = f" ({rec['reason']})"
            print(f"[{status}] {arch} x {shape} x {mesh_kind}{extra}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
