"""The port's boundaries: it imports neither jax nor the JAX package, it
never falls back quietly to the CPU when the card is asked for and
missing, and ``chip_smoke.py`` refuses to report without a card or
without the port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 57      # every ported module was imported


def test_chip_smoke_imports_no_jax_and_no_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_asking_for_the_card_without_one_raises(no_card):
    from repro_torch.core import (PerfPredictor, make_scenario,
                                  resolve_device, scenario_world)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerfPredictor()                           # engine="cuda" default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerfPredictor(engine="torch")             # device defaults to card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    pred = PerfPredictor(engine="numpy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pred.engine = "cuda"
    assert pred.engine == "numpy"
    assert PerfPredictor(engine="cuda", device="cpu").engine == "cuda"
    scn = make_scenario("burst-storm", n_functions=4, duration_s=10,
                        target_nodes=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenario_world(scn, n_train=50)


def test_service_engine_check(no_card):
    from repro_torch.core import (INFERENCE_ENGINES, GroundTruth,
                                  PerfPredictor, PredictionService,
                                  ProfileStore, QoSStore,
                                  synthetic_functions)
    assert INFERENCE_ENGINES == ("numpy", "torch", "cuda")
    store = ProfileStore(seed=0)
    svc = PredictionService(PerfPredictor(engine="numpy"), store,
                            QoSStore(store, GroundTruth(seed=0)),
                            synthetic_functions(2))
    for bad in ("jax", "pallas", "triton"):
        with pytest.raises(ValueError):
            svc.set_engine(bad)
    with pytest.raises(RuntimeError):
        svc.set_engine("cuda")
    assert svc.inference_engine == "numpy"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_port(tmp_path, alone):
    """Without a card (here), or copied alone into an empty directory
    (anywhere), chip_smoke.py exits non-zero and prints no result."""
    if alone:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(ROOT / "chip_smoke.py", script)
        cwd = tmp_path
    else:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the no-card path cannot run")
        script, cwd = ROOT / "chip_smoke.py", ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
