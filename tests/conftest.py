import os
import sys

import numpy as np
import pytest

# src layout import path (tests run with or without PYTHONPATH=src)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: no xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device (the dry-run sets its own flag in-process).


@pytest.fixture(autouse=True)
def _deterministic_global_rng():
    """Every test starts from the same legacy global numpy RNG state, so
    forest-dependent tests cannot depend on test/collection order (safe
    under ``pytest -p no:randomly`` and any reordering plugin).  All
    repro code seeds explicit ``default_rng`` instances; this pins down
    test-local and third-party ``np.random`` use."""
    np.random.seed(20260727)
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tpu_only: real-hardware Pallas path (interpret=False) that the "
        "CPU interpret mode cannot run; auto-skipped off-TPU")
    config.addinivalue_line(
        "markers",
        "slow: large-cluster / long-trace tests kept out of tier-1; run "
        "with RUN_SLOW=1 (scripts/verify.sh --full)")
    config.addinivalue_line("markers", "cuda_only: needs a CUDA card; the test skips itself without one")


def _on_tpu() -> bool:
    try:
        import jax
        return jax.default_backend() == "tpu"
    except Exception:
        return False


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RUN_SLOW") != "1":
        skip_slow = pytest.mark.skip(
            reason="slow: set RUN_SLOW=1 (or scripts/verify.sh --full)")
        for item in items:
            if "slow" in item.keywords:
                item.add_marker(skip_slow)
    if _on_tpu():
        return
    skip = pytest.mark.skip(
        reason="tpu_only: needs real TPU (Pallas interpret=False)")
    for item in items:
        if "tpu_only" in item.keywords:
            item.add_marker(skip)
