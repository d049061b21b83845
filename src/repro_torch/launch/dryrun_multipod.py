"""Multi-pod dry-run walkthrough, the port's twin of
``examples/dryrun_multipod.py``: trace ONE cell against the production
meshes (on a fake process group, no card) and print the memory, cost and
roofline summary.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_multipod \\
      [--arch qwen1.5-110b] [--shape train_4k] [--mesh both]

(The full sweep is ``python -m repro_torch.launch.dryrun --all``.)
``summary`` gives the lines of one ``dryrun.run_cell`` record, so a
caller can pass its own mesh and config.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

GIB = 2 ** 30


def summary(rec: dict) -> List[str]:
    """The example's lines for one cell's record."""
    mesh = "2x16x16" if rec["mesh"] == "multi" else "16x16"
    lines = [f"=== {rec['arch']} x {rec['shape']} x {rec['mesh']} ({mesh}) "
             "==="]
    if rec["status"] != "ok":
        return lines + [str(rec)]
    rf, mem = rec["roofline"], rec["memory"]
    lines += [
        # the port traces the step where the example lowers and compiles
        f"step={rec['step']} dispatch={rec['dispatch']} "
        f"build={rec['lower_s']:.1f}s trace={rec['trace_s']:.1f}s",
        f"per-device arg bytes: "
        f"{mem['arg_bytes_analytic_per_device'] / GIB:.2f} GiB",
        f"roofline: compute={rf['compute_s']:.3e}s "
        f"memory={rf['memory_s']:.3e}s "
        f"collective={rf['collective_s']:.3e}s "
        f"-> bottleneck: {rf['bottleneck']}",
        f"useful_ratio={rf['useful_ratio']:.3f} "
        f"roofline_frac={rf['roofline_frac']:.4f}",
        "collective schedule: " + str(
            {k: f"{v / GIB:.2f}GiB" for k, v in rec["collectives"].items()
             if isinstance(v, float) and v > 0})]
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .dryrun import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-110b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh in meshes:
        print()
        print("\n".join(summary(run_cell(args.arch, args.shape, mesh))))
    return 0


if __name__ == "__main__":
    main()
