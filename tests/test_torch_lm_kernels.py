"""The port's LM kernels on the CPU (their plain versions, through the
wrappers and ``kernels.ops``) against the JAX package's Pallas kernels in
interpret mode and its ``kernels.ref`` oracles, on the same numpy inputs.

Tolerances: f32 1e-5 (both sides compute in f32, summing in other
orders); bf16 2e-2 relative (the Pallas kernel rounds p to bf16 before
P.V, the plain version keeps it in f32, and the output is rounded to
bf16); the scan 1e-5 (the reference's serial scan, and its Pallas kernel,
against the port's serial loop).  The SSD scan 2e-4, as the reference's
own kernel test holds its Pallas kernel to its oracle: chunked against
token by token, sums of up to N + chunk products in other orders and
exp of differences of cumulative sums; bf16 inputs 2e-2 relative (both
compute in f32 from the same bf16 values, the output is rounded to
bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rglru_scan import rglru_scan as jscan
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models.ssd import ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (TF32_HEAD_DIMS,
                                                 WGMMA_BF16_HEAD_DIMS,
                                                 bwd_path, flash_attention)
from repro_torch.kernels.flash_attention import path as flash_path
from repro_torch.kernels.rglru_scan import path as scan_path
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import CHUNK, ssd_scan

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


@pytest.mark.parametrize("D", [16, 24, 32, 48, 64, 80, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_path_depends_on_dtype_and_head_dim_alone(dtype, D):
    """Head dims 64, 128 and 256 take a tensor-core kernel: bf16 the
    wgmma one, f32 the 3xTF32 one; bf16 at hubert-xlarge's 80 the wgmma
    one too (padded to two column blocks), f32 there the CUDA-core one;
    f32 at the ~100M training example's 96 the 3xTF32 one, bf16 there the
    CUDA-core one; any other head dim (the zoo's smoke configs use 16 and
    24) takes the CUDA-core kernel.  (f16 is refused by the wrapper
    before a path is chosen.)"""
    if dtype == torch.bfloat16:
        want = "wgmma" if D in (64, 80, 128, 256) else "simt"
    else:
        want = "tf32" if D in (64, 96, 128, 256) else "simt"
    assert flash_path(dtype, D) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_path_takes_a_softcap_where_it_takes_no_softcap(dtype, D):
    """A softcap moves no case: f32 stays on the 3xTF32 kernel at
    TF32_HEAD_DIMS (the example's 96 too; the kernel forms softcapped
    scores in double) and on the CUDA-core one elsewhere, bf16 on wgmma
    at its head dims."""
    for d in (D, 96):
        want = "tf32" if d in TF32_HEAD_DIMS else "simt"
        if dtype == torch.bfloat16:
            want = "wgmma" if d in WGMMA_BF16_HEAD_DIMS else "simt"
        assert flash_path(dtype, d, 30.0) == want == flash_path(dtype, d)
        assert bwd_path(dtype, d, 30.0) == want


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_paths_at_mla_head_dims(dtype, softcap):
    """MLA's q/k 192, v 128 takes the tensor-core kernels forward and
    backward, softcap or not: bf16 the wgmma ones, f32 the 3xTF32 ones.
    Other v widths at q/k 192 stay on the CUDA cores."""
    want = "wgmma" if dtype == torch.bfloat16 else "tf32"
    assert flash_path(dtype, 192, softcap, 128) == want
    assert bwd_path(dtype, 192, softcap, 128) == want
    for dv in (64, 96, 192):
        assert flash_path(dtype, 192, softcap, dv) == "simt"
        assert bwd_path(dtype, 192, softcap, dv) == "simt"


def _tf32_parts(x: torch.Tensor):
    """x's 3xTF32 operands: hi = tf32(x) and lo = tf32(x - hi), as the
    kernel hands them to the tensor core."""
    hi, lo = ref.tf32_split(x)
    return hi, ref.tf32_round(lo)


def _tf32_attention_model(q, k, v, terms: int = 3, bk: int = 32):
    """The f32 forward kernel's arithmetic (csrc/flash_attention_tf32.cu)
    on the CPU, causal: S = Q K^T with the large terms hi_q hi_k summed
    four columns at a time (one m16n8k4 product each, two a k8 step),
    added into s in f32 with Kahan's compensation, and the small terms
    lo_q hi_k + hi_q lo_k of each k8 step summed beside; then an online
    softmax over kv tiles of `bk` keys, P V in 3xTF32 a tile at a time
    and folded into the output in f32.  `terms` = 1 keeps hi_a hi_b
    alone (plain TF32)."""
    BH, S, D = q.shape
    qh, ql = _tf32_parts(q)
    kh, kl = _tf32_parts(k)
    vh, vl = _tf32_parts(v)
    kt_h, kt_l = kh.transpose(1, 2), kl.transpose(1, 2)
    s = torch.zeros(BH, S, S)
    small = torch.zeros(BH, S, S)
    for c in range(0, D, 8):
        lo, mid, hi = slice(c, c + 4), slice(c + 4, c + 8), slice(c, c + 8)
        big = qh[..., lo] @ kt_h[:, lo] + qh[..., mid] @ kt_h[:, mid]
        total = s + big
        small += (s - total) + big
        s = total
        if terms == 3:
            small += ql[..., hi] @ kt_h[:, hi] + qh[..., hi] @ kt_l[:, hi]
    s = (s + small) * np.float32(1.0 / np.sqrt(D))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, s, torch.tensor(ref.NEG_INF))
    m = torch.full((BH, S), -np.inf)
    den = torch.zeros(BH, S)
    acc = torch.zeros(BH, S, v.shape[2])
    for k0 in range(0, S, bk):
        tile = s[..., k0:k0 + bk]
        new = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp(m - new)
        p = torch.exp(tile - new[..., None])
        den = den * alpha + p.sum(-1)
        ph, pl = _tf32_parts(p)
        part = ph @ vh[:, k0:k0 + bk]
        if terms == 3:
            part = pl @ vh[:, k0:k0 + bk] + ph @ vl[:, k0:k0 + bk] + part
        acc = acc * alpha[..., None] + part
        m = new
    return acc / den[..., None]


def test_tf32_kernel_arithmetic_holds_f32_at_mla_head_dims():
    """The 3xTF32 forward's rounding, modelled on the CPU at MLA's q/k 192
    and v 128 (S ragged against the kv tile of 32): within the card's f32
    attention tolerance (1e-5 absolute plus 1e-5 relative) of the
    function evaluated in float64, where plain TF32 products miss it."""
    rng = np.random.default_rng(192)
    BH, S = 2, 100
    q, k = (torch.from_numpy(rng.standard_normal((BH, S, 192)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((BH, S, 128)).astype(
        np.float32))
    s = (q.double() @ k.double().transpose(1, 2)) / np.sqrt(192)
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, s, torch.tensor(-np.inf, dtype=torch.float64))
    want = (torch.softmax(s, -1) @ v.double()).numpy()
    got = _tf32_attention_model(q, k, v).double().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    one = _tf32_attention_model(q, k, v, terms=1).double().numpy()
    assert np.max(np.abs(one - want) / (1e-5 + 1e-5 * np.abs(want))) > 1.0


@pytest.mark.parametrize("kind,window,causal", [
    ("global", 0, True), ("local", 40, True), ("chunked", 32, True),
    ("local", 40, False)])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_attention_plain_bf16_at_head_dims_64_128_matches_pallas(
        D, kind, window, causal):
    """The plain version, which the wrapper takes on CPU tensors, at the
    tensor-core kernel's head dims in bf16 (64, 128 and hubert-xlarge's
    80, which the kernel pads to two column blocks) and a ragged S,
    against the Pallas kernel in interpret mode and the reference
    oracle: the function
    that kernel is held to on the card.  The kernel itself runs only in
    the cuda_only tests and chip_smoke."""
    rng = np.random.default_rng(D + window)
    BH, S = 2, 100
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (q, k, v))
    kw = dict(causal=causal, kind=kind, window=window)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    tol = TOL["bfloat16"]
    _close(got, jref.flash_attention_ref(jq, jk, jv, **kw), tol)
    _close(got, jflash(jq, jk, jv, interpret=True, **kw), tol)


def _fast_tanh_model(s: torch.Tensor, scale: float, softcap: float):
    """The wgmma kernels' softcap (``fast_tanh`` in csrc/hopper_wgmma.cuh)
    in f32 torch steps, on raw scores q.k: k2 = 2 log2(e) scale / softcap
    rounded to f32 as the host rounds it, r = 1 / (2^(|s| k2) + 1),
    tanh = sign(s) (1 - 2 r); returns the softcapped scores and the
    backward's 1 - tanh^2 as 4 r (1 - r).  The card's ex2.approx and
    rcp.approx add about 2^-22 relative to e and r."""
    log2e = float(np.float32(1.4426950408889634))
    k2 = float(np.float32(2.0 * log2e * scale / softcap))
    r = 1.0 / (torch.exp2(s.abs() * k2) + 1.0)
    t = torch.copysign(1.0 - 2.0 * r, s)
    return t * softcap, 4.0 * r * (1.0 - r)


@pytest.mark.parametrize("softcap", [50.0, 20.0])
@pytest.mark.parametrize("scale", [1.0, 4.0], ids=["unscaled", "scores_x16"])
def test_fast_tanh_softcap_holds_the_reference_and_lse_tolerances(scale,
                                                                  softcap):
    """The softcap as the wgmma forward and backward compute it (tanh from
    one exp2 and one reciprocal, no division a score), modelled in f32 on
    the CPU at gemma2-2b's head dim 256 on unscaled inputs and on scores
    scaled by 16: its attention output within the card's f32 attention
    tolerance (1e-5 absolute plus 1e-5 relative) of the reference's
    function (``jnp.tanh(s / c) * c``) evaluated in float64 on the same
    inputs, its row lse within a tenth of the card's lse tolerance (1e-4)
    of float64's, and 1 - t^2 within 1e-6 of float64's.  (The reference
    itself, in f32 under XLA, lies up to 3e-5 from float64 on the scaled
    scores.)"""
    rng = np.random.default_rng(int(scale * softcap))
    BH, S, D = 2, 100, 256
    q, k, v = ((rng.standard_normal((BH, S, D)) * (scale if i < 2 else 1.0))
               .astype(np.float32) for i in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    raw = tq @ tk.transpose(1, 2)
    x, f = _fast_tanh_model(raw, 1 / np.sqrt(D), softcap)
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    x = torch.where(keep, x, torch.tensor(ref.NEG_INF))
    got = torch.softmax(x, -1) @ tv
    y = raw.double() / np.sqrt(D) / softcap
    x64 = torch.where(keep, torch.tanh(y) * softcap,
                      torch.tensor(-np.inf, dtype=torch.float64))
    want = torch.softmax(x64, -1) @ tv.double()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    # the reference's function, its f32 evaluation in jax on these inputs
    _close(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), softcap=softcap),
           want.float(), 3e-5)
    lse_err = (torch.logsumexp(x, -1).double()
               - torch.logsumexp(x64, -1)).abs().max()
    assert float(lse_err) <= 1e-5
    assert float((f.double() - (1 - torch.tanh(y) ** 2)).abs().max()) <= 1e-6


def test_fwd_scratch_bytes_holds_every_share():
    """The split forward's scratch (wgmma and tf32): each share's f32
    (BH, S, Dv) output, maximum and sum; none unsplit."""
    from repro_torch.kernels.flash_attention import fwd_scratch_bytes
    assert fwd_scratch_bytes(1, 8, 3000, 256) == 0
    assert fwd_scratch_bytes(2, 8, 3000, 256) == 2 * 8 * 3000 * 258 * 4
    assert fwd_scratch_bytes(4, 10, 512, 128) == 4 * 10 * 512 * 130 * 4


def test_chip_smoke_names_each_kernel_in_the_ptxas_report():
    """chip_smoke phase 0's line an entry function: the name and template
    arguments demangled (past an anonymous namespace's), registers and
    spills."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ns = "_GLOBAL__N__a6294427_24_flash_attention_wgmma_cu_b1461615"
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        f"'_ZN{len(ns)}{ns}18flash_wgmma_kernelILi256ELi256ELi32ELb0EEEv"
        "14CUtensorMap_st' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 179 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z9rfr_emptyv' for "
        "'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 4 registers"])
    assert cs.ptxas_lines(log) == [
        "flash_wgmma_kernel<256,256,32,0>: 179 registers; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads",
        "rfr_empty: 4 registers; 8 bytes stack frame, 4 bytes spill stores, "
        "8 bytes spill loads"]


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


@pytest.mark.parametrize("B,S,W,want", [(1, 3000, 2560, "tma"),
                                        (4, 1000, 2560, "tma"),
                                        (1, 1, 2560, "tma"),
                                        (1, 3000, 2562, "simt"),
                                        (2, 257, 8, "tma"),
                                        (2, 257, 1, "simt"),
                                        (1, 1, 8, "tma"),
                                        (1, 1, 2562, "simt")])
def test_rglru_path_takes_tma_where_rows_are_16_byte_multiples(B, S, W,
                                                              want):
    """The TMA kernel's tensor map needs a row stride that is a multiple
    of 16 bytes: W % 4 == 0 takes it (recurrentgemma's 2,560 among them),
    every other W the one-thread-per-channel kernel; S = 1 is a TMA
    shape too (one stage, read past its end as zeros)."""
    assert scan_path(B, S, W) == want


def test_rglru_scan_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(2, 8, 4)
    with pytest.raises(TypeError):
        rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError):
        rglru_scan(a, torch.zeros(2, 8, 5))
    with pytest.raises(ValueError):
        rglru_scan(a, a, torch.zeros(2, 5))


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan
# ---------------------------------------------------------------------------

SSD_TOL = 2e-4
#: the state-passing plain version against the Pallas kernel and the JAX
#: model's ``ssd_chunked``, all f32: 1e-5 of the largest |y| (and of the
#: largest |h| for the state) plus 1e-5 relative; the same function,
#: summed in other orders and chunkings
SSD_SCALE_TOL = 1e-5


def _close_scaled(got, want, tol=SSD_SCALE_TOL):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _ssd_inputs(seed, B, H, S, P, N, G=None):
    """x, dA (negative), dt (positive), Bm, Cm, h0 as numpy f32; Bm and
    Cm with G groups (H when None)."""
    rng = np.random.default_rng(seed)
    G = G or H
    sp = lambda a: np.log1p(np.exp(a))
    x = rng.standard_normal((B, H, S, P)).astype(np.float32)
    dA = (-sp(rng.standard_normal((B, H, S)))).astype(np.float32)
    dt = sp(rng.standard_normal((B, H, S))).astype(np.float32)
    Bm = rng.standard_normal((B, G, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, G, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dA, dt, Bm, Cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 32), (96, 32),
                                     (37, 8),     # prime: a ragged chunk
                                     (100, 32)])  # ragged, 4 chunks
def test_ssd_scan_matches_pallas_and_ref(S, chunk, with_h0):
    """The plain chunked version at the Pallas kernel's chunk and the
    wrapper (at the kernel's own chunk) against the Pallas kernel in
    interpret mode and the reference's token-by-token oracle.  The
    Pallas kernel shrinks its chunk until it divides S (to 1 at S = 37);
    the port takes a ragged last chunk."""
    x, dA, dt, Bm, Cm, h0 = _ssd_inputs(S + chunk, 2, 3, S, 8, 16)
    if not with_h0:
        h0 = None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    args_t = [t(a) for a in (x, dA, dt, Bm, Cm, h0)]
    args_j = [j(a) for a in (x, dA, dt, Bm, Cm, h0)]
    y_plain, h_plain = ref.ssd_scan_ref(*args_t, chunk=chunk)
    y_wrap, h_wrap = ssd_scan(*args_t)
    assert y_wrap.dtype == torch.float32 and h_wrap.dtype == torch.float32
    assert h_wrap.shape == (2, 3, 8, 16)
    y_ref, h_ref = jref.ssd_scan_ref(*args_j)
    y_pal, h_pal = jssd(*args_j, chunk=chunk, interpret=True)
    for y, h in ((y_plain, h_plain), (y_wrap, h_wrap)):
        for yw, hw in ((y_ref, h_ref), (y_pal, h_pal)):
            _close(y, yw, SSD_TOL)
            _close(h, hw, SSD_TOL)
        _close_scaled(y, y_pal)
        _close_scaled(h, h_pal)


def test_ssd_scan_chains_state():
    """Two halves chained through h0 equal one pass, and the reference's
    oracle over the whole sequence (``test_kernels.py``'s chaining case,
    with a split inside a chunk)."""
    x, dA, dt, Bm, Cm, _ = _ssd_inputs(8, 1, 2, 70, 4, 8)
    args = [torch.from_numpy(a) for a in (x, dA, dt, Bm, Cm)]
    y_full, h_full = ssd_scan(*args)
    half = 29
    first = [a[:, :, :half].contiguous() for a in args]
    second = [a[:, :, half:].contiguous() for a in args]
    y1, h1 = ssd_scan(*first)
    y2, h2 = ssd_scan(*second, h1)
    _close(torch.cat([y1, y2], dim=2), y_full, SSD_TOL)
    _close(h2, h_full, SSD_TOL)
    y_ref, h_ref = jref.ssd_scan_ref(*(jnp.asarray(a)
                                       for a in (x, dA, dt, Bm, Cm)))
    _close(y2, np.asarray(y_ref)[:, :, half:], SSD_TOL)
    _close(h2, h_ref, SSD_TOL)


def test_ssd_scan_bf16_inputs():
    """bf16 x, B and C: y comes back in bf16, the state in f32, both
    close to the Pallas kernel on the same bf16 values."""
    x, dA, dt, Bm, Cm, h0 = _ssd_inputs(9, 2, 2, 48, 8, 16)
    (jx, tx), (jB, tB), (jC, tC) = (_pair(a, "bfloat16") for a in (x, Bm, Cm))
    tdA, tdt, th0 = (torch.from_numpy(a) for a in (dA, dt, h0))
    y, h = ssd_scan(tx, tdA, tdt, tB, tC, th0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_pal, h_pal = jssd(jx, jnp.asarray(dA), jnp.asarray(dt), jB, jC,
                        jnp.asarray(h0), chunk=16, interpret=True)
    assert y_pal.dtype == jnp.bfloat16
    tol = TOL["bfloat16"]
    scale = float(np.abs(_np(y_pal)).max())
    np.testing.assert_allclose(_np(y), _np(y_pal), atol=tol * scale,
                               rtol=tol)
    np.testing.assert_allclose(_np(h), _np(h_pal), atol=SSD_TOL,
                               rtol=SSD_TOL)


@pytest.mark.parametrize("H,G", [(4, 4), (4, 2), (6, 1)])
def test_ssd_op_matches_reference_op(H, G):
    """``ops.ssd_op`` in the model layout, B and C given per group (the
    kernel reads group h // (H / G)), against the reference's ``ssd_op``
    given them repeated to every head, Pallas and jnp paths."""
    rng = np.random.default_rng(H * 10 + G)
    Bsz, S, P, N = 2, 40, 8, 16
    x = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(
        np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bg = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    Cg = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    h0 = rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
    Bh, Ch = (np.repeat(a, H // G, axis=2) for a in (Bg, Cg))
    t = torch.from_numpy
    for use_kernel in (True, False):
        y, h = ops.ssd_op(t(x), t(dt), t(A), t(Bg), t(Cg), t(h0), chunk=16,
                          use_kernel=use_kernel)
        assert y.shape == (Bsz, S, H, P) and h.shape == (Bsz, H, P, N)
        yr, hr = ops.ssd_op(t(x), t(dt), t(A), t(Bh), t(Ch), t(h0),
                            chunk=16, use_kernel=use_kernel)
        _close(y, yr, SSD_TOL)
        _close(h, hr, SSD_TOL)
        for use_pallas in (False, True):
            yj, hj = jops.ssd_op(*(jnp.asarray(a) for a in
                                   (x, dt, A, Bh, Ch, h0)), chunk=16,
                                 use_pallas=use_pallas, interpret=True)
            _close(y, yj, SSD_TOL)
            _close(h, hj, SSD_TOL)
        yc, hc = ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bh, Ch)),
                             16, jnp.asarray(h0))
        _close_scaled(y, yc)
        _close_scaled(h, hc)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S,chunk", [(37, 16),    # prime: ragged chunks
                                     (64, 64),    # one whole chunk
                                     (130, 32)])  # two kernel chunks + 2
def test_ssd_state_passing_matches_jax_chunked(S, chunk, G, with_h0):
    """The state-passing plain version (chunk-local products, the pass in
    time, the output), at the caller's chunk and at the kernels' own
    (through the wrapper on CPU tensors), against the JAX model's
    ``ssd_chunked`` and the Pallas kernel in interpret mode, in the model
    layout: G = 1 and G = H groups, h0 given and absent, ragged chunks."""
    rng = np.random.default_rng(S * 10 + G + 100 * with_h0)
    Bsz, H, P, N = 2, 4, 8, 16
    x = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(
        np.float32)
    A = -np.linspace(0.5, 3.0, H).astype(np.float32)
    Bg = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    Cg = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    h0 = (rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
          if with_h0 else None)
    Bh, Ch = (np.repeat(a, H // G, axis=2) for a in (Bg, Cg))
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    yc, hc = ssd_chunked(*(j(a) for a in (x, dt, A, Bh, Ch)), chunk, j(h0))
    yp, hp = jops.ssd_op(*(j(a) for a in (x, dt, A, Bh, Ch, h0)),
                         chunk=chunk, use_pallas=True, interpret=True)
    args = [t(a) for a in (x, dt, A, Bg, Cg, h0)]
    for use_kernel in (False, True):     # chunk, then the kernels' CHUNK
        y, h = ops.ssd_op(*args, chunk=chunk, use_kernel=use_kernel)
        assert y.shape == (Bsz, S, H, P) and h.shape == (Bsz, H, P, N)
        for yw, hw in ((yc, hc), (yp, hp)):
            _close_scaled(y, yw)
            _close_scaled(h, hw)
    # the wrapper is the plain version at the kernels' chunk
    xt, dtt = t(x).transpose(1, 2).contiguous(), t(dt).transpose(1, 2)
    y64, h64 = ref.ssd_scan_ref(xt, (dtt * t(A)[None, :, None]).contiguous(),
                                dtt.contiguous(),
                                t(Bg).transpose(1, 2).contiguous(),
                                t(Cg).transpose(1, 2).contiguous(), t(h0),
                                chunk=CHUNK)
    _close(y, y64.transpose(1, 2), 0.0)
    _close(h, h64, 0.0)


def test_tf32_split_is_exact_and_three_products_hold_f32():
    """The f32 attention kernel's operand split: hi + lo == x bitwise, hi
    has TF32's 10 mantissa bits, and lo_a hi_b + hi_a lo_b + hi_a hi_b
    (lo rounded to TF32, as the tensor core reads it) is within 2^-20 of
    the exact product of the f32 values, relative, where hi_a hi_b alone
    is not."""
    rng = np.random.default_rng(16)
    a = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
         ).astype(np.float32)
    b = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
         ).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    (ha, la), (hb, lb) = ref.tf32_split(ta), ref.tf32_split(tb)
    assert torch.equal((ha + la).view(torch.int32), ta.view(torch.int32))
    assert not bool((ha.view(torch.int32) & 0x1FFF).any())
    assert bool((la.abs() <= ha.abs() * 2.0 ** -11).all())
    la, lb = ref.tf32_round(la), ref.tf32_round(lb)
    exact = a.astype(np.float64) * b.astype(np.float64)
    d = lambda x: x.numpy().astype(np.float64)
    three = d(la) * d(hb) + d(ha) * d(lb) + d(ha) * d(hb)
    assert np.max(np.abs(three - exact) / np.abs(exact)) <= 2.0 ** -20
    assert np.max(np.abs(d(ha) * d(hb) - exact) / np.abs(exact)) > 2.0 ** -14
    # round to nearest, ties away from zero, as cvt.rna.tf32.f32
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -12], dtype=torch.float32)
    assert ref.tf32_round(tie).tolist() == [1.0 + 2.0 ** -10,
                                            -(1.0 + 2.0 ** -10), 1.0]


def test_ssd_scan_rejects_what_the_kernel_does_not_take():
    x, dA, dt, Bm, Cm, h0 = (torch.from_numpy(a) for a in
                             _ssd_inputs(0, 1, 4, 8, 4, 8))
    with pytest.raises(ValueError, match="group"):
        ssd_scan(x, dA, dt, Bm[:, :3].contiguous(), Cm[:, :3].contiguous())
    with pytest.raises(ValueError, match="d_state"):
        big = torch.zeros(1, 4, 8, 129)
        ssd_scan(x, dA, dt, big, big)
    with pytest.raises(TypeError):
        ssd_scan(x.double(), dA, dt, Bm.double(), Cm.double())
    with pytest.raises(TypeError):
        ssd_scan(x, dA, dt, Bm.bfloat16(), Cm.bfloat16())
    with pytest.raises(TypeError):
        ssd_scan(x, dA.double(), dt, Bm, Cm)
    with pytest.raises(ValueError):
        ssd_scan(x, dA[:, :, :5], dt, Bm, Cm)
    with pytest.raises(ValueError):
        ssd_scan(x, dA, dt, Bm, Cm, h0[:, :, :3])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dA, dt,
                 Bm, Cm)
