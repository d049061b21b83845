"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/kernels/`` at the repository root, named by
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built when the package is
imported: the first call that needs a kernel builds it, and a build that
fails raises with the compiler's output.

``build_all()`` starts one ``nvcc`` per source at once and waits for
all of them; ``load(name)`` returns the loaded library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: sources of the port's kernels, by library name
SOURCES: Dict[str, str] = {"rfr_inference": "rfr_inference.cu",
                           "flash_attention": "flash_attention.cu",
                           "rglru_scan": "rglru_scan.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

#: C signatures: name -> (argtypes, restype); every entry point returns
#: its cudaGetLastError() as an int
SIGNATURES: Dict[str, Dict[str, Tuple[list, type]]] = {
    "rfr_inference": {
        # x, feat, thr, leaf, out, n, f, n_trees, depth, device, stream
        "rfr_forest_apply": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
                             _I),
        # x, bounds, feat, thr, leaf, out, s, m, r, f, n_trees, depth,
        # log_target, device, stream
        "rfr_capacity_sweep": ([_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                _I, _I, _I, _P], _I),
    },
    "flash_attention": {
        # q, k, v, o, bh, s, d, group, is_bf16, causal, kind, window,
        # softcap, stream
        "flash_attention_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _D, _P], _I),
    },
    "rglru_scan": {
        # a, b, h0 (or null), h, batch, s, w, stream
        "rglru_scan_fwd": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    """Start nvcc for `name` unless its library is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path):
    out, _ = proc.communicate()
    log = lib.with_suffix(".log")
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)        # atomic: a reader sees all or nothing


def build_all(names: Iterable[str] = tuple(SOURCES)) -> List[str]:
    """Compile every named source that is not built yet, all at once.
    Returns the names that were compiled."""
    started = []
    for name in names:
        job = _start(name)
        if job is not None:
            started.append((name, *job))
    for name, proc, tmp, lib in started:
        _finish(name, proc, tmp, lib)
    return [s[0] for s in started]


def build_log(name: str) -> str:
    """What nvcc printed for `name`'s current build (ptxas register and
    shared-memory use), or '' when it was built by an earlier process
    that left no log."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_launch(err: int, kernel: str):
    """Raise when an entry point returned a CUDA error (a refused launch
    never runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _LIBS[name] = lib
    return lib
