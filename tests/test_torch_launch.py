"""The port's serving entry points against the reference's on the CPU:
``repro_torch.launch.serve`` prints ``repro.launch.serve``'s outcome
lines for every scheduler, and ``repro_torch.launch.serve_cluster``
prints ``examples/serve_cluster.py``'s status lines, served counts,
releases and logical starts, on the example's own smoke weights carried
over with ``params_from_numpy``.

Both packages draw from the same seeds; only wall-clock fields are
masked (``WALL_CLOCK``).  The serving engines of both packages number
their instances with a class-level counter, which decides the order a
set of cached instances is revived in; each case starts both counters
at 0, as a fresh process would."""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.launch import serve as ref_serve
from repro.models import model as jmodel
from repro.serving.engine import ServingInstance as JServingInstance
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve, serve_cluster
from repro_torch.models import params_from_numpy
from repro_torch.serving.engine import ServingEngine, ServingInstance

ROOT = Path(__file__).resolve().parents[1]
#: the fields that read the wall clock: the serve driver's mean
#: scheduling latency and mean cold start, the cluster's p90 latency
WALL_CLOCK = re.compile(r"(mean latency|mean cold start|p90) [0-9.]+ ms")


def _masked(text: str) -> list:
    return [WALL_CLOCK.sub(r"\1 <wall clock> ms", line)
            for line in text.splitlines()]


@pytest.fixture(autouse=True)
def fresh_instance_ids(monkeypatch):
    monkeypatch.setattr(JServingInstance, "_ids", 0)
    monkeypatch.setattr(ServingInstance, "_ids", 0)


@pytest.mark.parametrize("argv", [
    ["--seconds", "60", "--scheduler", "jiagu"],
    ["--seconds", "60", "--scheduler", "gsight"],
    ["--seconds", "60", "--scheduler", "owl"],
    ["--seconds", "60", "--scheduler", "k8s"],
    [],                                   # jiagu over the default 600 s
], ids=["jiagu-60", "gsight-60", "owl-60", "k8s-60", "jiagu-600"])
def test_serve_prints_the_reference_outcomes(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    ref_serve.main()
    want = capsys.readouterr().out
    serve.main(argv + ["--engine", "torch", "--device", "cpu"])
    got = capsys.readouterr().out
    assert len(want.splitlines()) == 4
    assert _masked(got) == _masked(want)


def test_serve_run_returns_the_printed_result():
    args = serve.parse_args(["--seconds", "30", "--engine", "numpy"])
    res = serve.run(args)
    assert res.sched.decisions > 0 and res.scaling.releases >= 0
    assert serve.parse_args([]).engine == "cuda"


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "serve_cluster_example", ROOT / "examples" / "serve_cluster.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: arguments under which the example releases replicas and revives them
#: by logical starts (mamba2-2.7b: 2 and 2 under the sinusoid, 3 and 3
#: under burst-storm); at the example's defaults it does neither
CLUSTER_ARGS = {
    "sinusoid": ["--seconds", "20", "--release-after", "2"],
    "burst-storm": ["--seconds", "16", "--release-after", "2",
                    "--scenario", "burst-storm"],
}


@pytest.mark.parametrize("scenario", sorted(CLUSTER_ARGS))
def test_serve_cluster_twin_prints_the_example(scenario, monkeypatch,
                                               capsys):
    argv = CLUSTER_ARGS[scenario]
    monkeypatch.setattr(sys, "argv", ["serve_cluster.py"] + argv)
    _load_example().main()
    want = _masked(capsys.readouterr().out)
    closing = [line for line in want if not line.startswith("t=")]
    assert len(closing) == 2
    assert any(" 0 releases" not in line and " 0 logical" not in line
               for line in closing), closing

    # the example's weights: init_params at PRNGKey(0) for each arch
    engines = {}
    for arch in serve_cluster.ARCHS:
        jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
        tree = jax.tree.map(np.asarray,
                            jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
        eng = ServingEngine(cfg, params_from_numpy(cfg, tree, device="cpu"),
                            slots=serve_cluster.SLOTS,
                            max_len=serve_cluster.MAX_LEN, device="cpu")
        eng.scale_up(serve_cluster.REPLICAS)
        engines[arch] = eng
    # the same instance numbers as the example's: 1-2 and 3-4
    assert [sorted(e.instances) for e in engines.values()] == [[1, 2],
                                                               [3, 4]]
    seconds, release_after = int(argv[1]), int(argv[3])
    load = serve_cluster.offered_load(scenario, list(engines), seconds)
    stats = serve_cluster.run(engines, seconds, release_after, load,
                              np.random.default_rng(0))
    assert _masked(capsys.readouterr().out) == want
    for arch, s in stats.items():
        assert all(len(r.tokens) == serve_cluster.MAX_NEW
                   for r in s["served"])


def test_entry_points_ask_for_the_card(monkeypatch):
    """Without --engine / --device both entry points run on the card,
    and raise where there is none: nothing carries on on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--seconds", "10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cluster.main(["--seconds", "2"])
