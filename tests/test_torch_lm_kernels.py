"""The port's LM kernels on the CPU (their plain versions, through the
wrappers and ``kernels.ops``) against the JAX package's Pallas kernels in
interpret mode and its ``kernels.ref`` oracles, on the same numpy inputs.

Tolerances: f32 1e-5 (both sides compute in f32, summing in other
orders); bf16 2e-2 relative (the Pallas kernel rounds p to bf16 before
P.V, the plain version keeps it in f32, and the output is rounded to
bf16); the scan 1e-5 (the reference's serial scan, and its Pallas kernel,
against the port's serial loop)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rglru_scan import rglru_scan as jscan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of `dtype`
    (both round f32 to bf16 to nearest even)."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,window,S,causal,softcap,scale", [
    ("global", 0, 64, True, 0.0, 1.0), ("global", 0, 128, True, 0.0, 1.0),
    ("local", 32, 64, True, 0.0, 1.0), ("local", 32, 128, True, 0.0, 1.0),
    ("chunked", 32, 64, True, 0.0, 1.0), ("chunked", 32, 128, True, 0.0, 1.0),
    ("global", 0, 100, True, 0.0, 1.0),      # ragged: no tile divides 100
    ("local", 32, 100, True, 0.0, 1.0),
    ("chunked", 32, 100, True, 0.0, 1.0),
    ("global", 0, 64, True, 20.0, 4.0),      # softcap on large scores
    ("global", 0, 96, False, 0.0, 1.0),      # non-causal
])
def test_flash_attention_matches_pallas_and_ref(kind, window, S, causal,
                                                softcap, scale, dtype):
    rng = np.random.default_rng(S * 7 + window)
    BH, D = 4, 32
    q, k, v = ((rng.standard_normal((BH, S, D)) * s).astype(np.float32)
               for s in (scale, scale, 1.0))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, kind=kind, window=window, softcap=softcap)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, ref.flash_attention_ref(tq, tk, tv, **kw), 0.0)
    tol = TOL[dtype]
    _close(got, jref.flash_attention_ref(jq, jk, jv, **kw), tol)
    _close(got, jflash(jq, jk, jv, interpret=True, **kw), tol)


@pytest.mark.parametrize("B,Hq,Hkv", [(2, 4, 2), (2, 10, 1), (1, 10, 1)])
def test_attention_op_grouped_heads(B, Hq, Hkv):
    """``ops.attention_op`` on (B, S, H, D) with GQA / MQA: the wrapper
    groups kv rows itself, the plain path repeats k and v.  B = 1 is the
    serving layout, where merging batch and heads is a strided view."""
    rng = np.random.default_rng(Hq)
    S, D = 64, 16
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.attention_op(tq, tk, tv, kind="local", window=24)
    plain = ops.attention_op(tq, tk, tv, kind="local", window=24,
                             use_kernel=False)
    assert got.shape == (B, S, Hq, D)
    _close(got, plain, 0.0)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for use_pallas in (True, False):
        want = jops.attention_op(jq, jk, jv, kind="local", window=24,
                                 use_pallas=use_pallas, interpret=True)
        _close(got, want, TOL["float32"])


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(2, 8, 512), torch.zeros(2, 8, 512),
                        torch.zeros(2, 8, 512))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q, q, q, kind="local", window=0)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, kind="sliding")
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,W,with_h0", [(32, 64, False), (128, 128, False),
                                         (100, 96, False), (48, 64, True),
                                         (100, 96, True)])
def test_rglru_scan_matches_pallas_and_ref(S, W, with_h0):
    rng = np.random.default_rng(S + W)
    B = 2
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))).astype(
        np.float32)                                   # decay in (0, 1)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    th0 = None if h0 is None else torch.from_numpy(h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = rglru_scan(ta, tb, th0)
    _close(got, ops.rglru_op(ta, tb, th0, use_kernel=False), 0.0)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(got, jref.rglru_scan_ref(ja, jb, jh0), TOL["float32"])
    _close(got, jscan(ja, jb, jh0, interpret=True), TOL["float32"])
    _close(got, jops.rglru_op(ja, jb, jh0, use_pallas=True, interpret=True),
           TOL["float32"])


def test_rglru_scan_chains_state():
    """Splitting a sequence and chaining the state equals one scan."""
    rng = np.random.default_rng(6)
    B, S, W = 1, 64, 32
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (B, S, W)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    full = rglru_scan(a, b)
    second = rglru_scan(a[:, S // 2:].contiguous(), b[:, S // 2:].contiguous(),
                        full[:, S // 2 - 1].contiguous())
    _close(second, full[:, S // 2:], 0.0)


def test_rglru_scan_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(2, 8, 4)
    with pytest.raises(TypeError):
        rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError):
        rglru_scan(a, torch.zeros(2, 8, 5))
    with pytest.raises(ValueError):
        rglru_scan(a, a, torch.zeros(2, 5))
