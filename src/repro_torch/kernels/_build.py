"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers it
includes) is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/kernels/`` at the repository root, named by a hash of
its source, the headers and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  Nothing is built when the package is
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
                           "flash_attention_wgmma": "flash_attention_wgmma.cu",
                           "flash_attention_tf32": "flash_attention_tf32.cu",
                           "flash_attention_bwd": "flash_attention_bwd.cu",
                           "flash_attention_bwd_wgmma":
                               "flash_attention_bwd_wgmma.cu",
                           "flash_attention_bwd_tf32":
                               "flash_attention_bwd_tf32.cu",
                           "rglru_scan": "rglru_scan.cu",
                           "ssd_scan": "ssd_scan.cu",
                           "ssd_scan_wgmma": "ssd_scan_wgmma.cu",
                           "ssd_scan_bwd": "ssd_scan_bwd.cu",
                           "ssd_scan_bwd_wgmma": "ssd_scan_bwd_wgmma.cu",
                           "ssd_scan_tf32": "ssd_scan_tf32.cu",
                           "ssd_scan_bwd_tf32": "ssd_scan_bwd_tf32.cu",
                           "adamw": "adamw.cu"}

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
        # x, feat, thr, leaf, out, n, f, n_trees, depth, in_smem, device,
        # stream
        "rfr_forest_apply": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                              _P], _I),
        # the first design, one thread a row: the same without in_smem
        "rfr_forest_apply_v1": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                 _P], _I),
        # stream: an empty kernel
        "rfr_empty": ([_P], _I),
        # x, bounds, feat, thr, leaf, out, s, m, r, f, n_trees, depth,
        # log_target, device, stream
        "rfr_capacity_sweep": ([_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                _I, _I, _I, _P], _I),
    },
    "flash_attention": {
        # q, k, v, o, bh, s, d, dv, group, is_bf16, causal, kind, window,
        # softcap, stream
        "flash_attention_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _D, _P], _I),
    },
    "flash_attention_wgmma": {
        # q, k, v, o, lse (or null), part (scratch or null), bh, s, d, dv,
        # group, causal, kind, window, softcap, splits, stream
        "flash_attention_wgmma_fwd": ([_P] * 6 + [_I] * 8 + [_D, _I, _P], _I),
        # bh, s, d, dv, causal, kind, window -> the kv shares fwd takes
        "flash_attention_wgmma_splits": ([_I] * 7, _I),
    },
    "flash_attention_tf32": {
        # q, k, v, o, part (scratch or null), lse (or null), bh, s, d, dv,
        # group, causal, kind, window, softcap, splits, stream
        "flash_attention_tf32_fwd": ([_P] * 6 + [_I] * 8 + [_D, _I, _P], _I),
        # bh, s, d, dv, causal, kind, window -> the kv shares fwd takes
        "flash_attention_tf32_splits": ([_I] * 7, _I),
    },
    "flash_attention_bwd": {
        # q, k, v, o, dout, dq, dk, dv, lse and delta scratch, bh, s, d,
        # dv, group, is_bf16, causal, kind, window, softcap, stream
        "flash_attention_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _D, _P],
                                _I),
    },
    "flash_attention_bwd_wgmma": {
        # bh, s, d, dv, group, causal, kind, window -> the dK/dV shares
        "flash_attention_bwd_wgmma_shares": ([_I] * 8, _I),
        # q, k, v, o, dout, lse, dq, dk, dv, delta and partials scratch,
        # bh, s, d, dv, group, shares, causal, kind, window, softcap,
        # stream
        "flash_attention_bwd_wgmma": ([_P] * 11 + [_I] * 9 + [_D, _P], _I),
    },
    "flash_attention_bwd_tf32": {
        # the wgmma backward's entry points, for f32; the share count
        # also takes whether the scores are softcapped (its own
        # instantiation's occupancy)
        "flash_attention_bwd_tf32_shares": ([_I] * 9, _I),
        "flash_attention_bwd_tf32": ([_P] * 11 + [_I] * 9 + [_D, _P], _I),
    },
    "rglru_scan": {
        # both: a, b, h0 (or null), h, batch, s, w, stream
        "rglru_scan_fwd": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "rglru_scan_tma_fwd": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        # both backward: a, h, dh, h0 (or null), da, db, dh0 (or null),
        # batch, s, w, stream
        "rglru_scan_bwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        "rglru_scan_tma_bwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                               _I),
    },
    "ssd_scan": {
        # x, dA, dt, Bm, Cm, h0 (or null), y, hout, batch, heads, groups,
        # s, p, n, is_bf16, stream
        "ssd_scan_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _P], _I),
    },
    "ssd_scan_wgmma": {
        # x, dA, dt, Bm, Cm, h0 (or null), y, hout, hin scratch, batch,
        # heads, groups, s, stream
        "ssd_scan_wgmma_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _P], _I),
    },
    "ssd_scan_bwd": {
        # batch, heads, s, p, n -> bytes of scratch
        "ssd_scan_bwd_scratch_bytes": ([_I, _I, _I, _I, _I], _L),
        # x, dA, dt, Bm, Cm, h0 (or null), dy, dh (or null), dx, ddA, ddt,
        # dB, dC, dh0 (or null), scratch, batch, heads, groups, s, p, n,
        # is_bf16, stream
        "ssd_scan_bwd": ([_P] * 15 + [_I] * 7 + [_P], _I),
    },
    "ssd_scan_bwd_wgmma": {
        # batch, heads, groups, s -> bytes of scratch
        "ssd_scan_bwd_wgmma_scratch_bytes": ([_I, _I, _I, _I], _L),
        # x, dA, dt, Bm, Cm, h0 (or null), dy, dh (or null), dx, ddA, ddt,
        # dB, dC, dh0 (or null), scratch, batch, heads, groups, s, stream
        "ssd_scan_bwd_wgmma": ([_P] * 15 + [_I] * 4 + [_P], _I),
    },
    "ssd_scan_tf32": {
        # the wgmma forward's arguments, for f32: hin scratch of
        # (batch, heads, ceil(s / 64), 64, 128) f32
        "ssd_scan_tf32_fwd": ([_P] * 9 + [_I] * 4 + [_P], _I),
    },
    "ssd_scan_bwd_tf32": {
        # the wgmma backward's entry points, for f32
        "ssd_scan_bwd_tf32_scratch_bytes": ([_I, _I, _I, _I], _L),
        "ssd_scan_bwd_tf32": ([_P] * 15 + [_I] * 4 + [_P], _I),
    },
    "adamw": {
        # p, g, m, v, held (bf16, or null), their dtype codes (p, g, m: 0
        # f32, 1 bf16, 2 f16), n, head, nvec, scale, lr,
        # b1c, b2c, b1, 1 - b1, b2, 1 - b2, eps, weight_decay, decay,
        # stream
        "adamw_update": ([_P] * 5 + [_I] * 3 + [_L] * 3 + [_P] * 4
                         + [_D] * 6 + [_I, _P], _I),
        # nvec -> the partials grad_sumsq_partials writes for a leaf
        "grad_sumsq_blocks": ([_L], _L),
        # x, dtype code, n, head, nvec, partials, stream
        "grad_sumsq_partials": ([_P, _I, _L, _L, _L, _P, _P], _I),
        # partials, count, sumsq (f64, or null), norm (f32, or null),
        # stream
        "grad_sumsq_finish": ([_P, _L, _P, _P, _P], _I),
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
    """The library of `name`, named by a hash of its source, the shared
    headers it may include and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
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
