"""The port's CUDA kernels against their plain versions, on the card.

Every test is ``cuda``-marked and skips without a card. The file imports no
jax, so it runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the SSD backward against its plain version: max |got - want| <= SSD_BWD_TOL
# * max |want| per gradient, and the cases where H is no power of two and the
# backward groups heads; one copy, the card check's
from chip_smoke import SSD_BWD_GROUP_CASES, SSD_BWD_TOL  # noqa: E402
# the attention shapes whisper-medium and llava-next-34b serve and train at
# (B, S, T, H, KV, hd, causal): whisper's encoder (non-causal, a ragged T of
# 1500), cross- (T != S) and decoder self-attention, llava's GQA group of 7
from chip_smoke import ENCDEC_VLM_SHAPES  # noqa: E402

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref as tref  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2
SSD_TOL = 1e-4  # tests/test_kernels.py's SSD tolerance

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, dtype, B, S, T, H, KV, hd, seed=9):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(device, dtype)
                 for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


@pytest.mark.parametrize("B,S,T,H,KV,hd,dtype,kw", [
    (1, 128, 128, 4, 4, 32, "float32", dict(causal=True)),            # MHA
    (2, 128, 128, 4, 2, 32, "float32", dict(causal=False)),           # GQA
    (1, 256, 256, 8, 1, 16, "float32", dict(causal=True)),            # MQA
    (1, 192, 192, 2, 2, 64, "float32", dict(causal=True)),
    (1, 256, 256, 4, 4, 32, "float32", dict(causal=True, window=32)),
    (1, 256, 256, 4, 4, 32, "float32", dict(causal=True, window=96)),
    (1, 128, 128, 2, 2, 32, "float32", dict(causal=True, softcap=20.0)),
    (1, 1000, 1000, 4, 2, 64, "float32", dict(causal=True)),          # ragged
    (1, 96, 160, 4, 2, 128, "float32", dict(causal=False)),           # T != S
    (1, 64, 8, 2, 2, 16, "float32", dict(causal=True, window=4)),     # empty rows
    (1, 128, 128, 4, 2, 32, "bfloat16", dict(causal=True)),           # bf16, mma route
    # zamba2-7b's 112, h2o-danube's 120: wgmma in bf16 (the hd-128 instance,
    # zero-padded), mma in f32
    *[case for hd in (112, 120) for dt in ("float32", "bfloat16") for case in (
        (1, 1000, 1000, 4, 2, hd, dt, dict(causal=True)),             # ragged, GQA
        (1, 256, 256, 4, 4, hd, dt, dict(causal=True, window=96)),
        (1, 128, 128, 2, 2, hd, dt, dict(causal=True, softcap=20.0)),
        (1, 64, 8, 2, 2, hd, dt, dict(causal=True, window=4)),         # empty rows
    )],
    # the wgmma route's padded head dims, bf16: ragged S, T != S, window,
    # softcap, GQA and MHA, empty rows, more work tiles than SMs
    *[case for hd in (72, 96, 112, 120) for case in (
        (1, 1000, 1000, 4, 2, hd, "bfloat16", dict(causal=True, window=96)),
        (1, 96, 160, 4, 4, hd, "bfloat16", dict(causal=False)),
        (1, 160, 96, 4, 2, hd, "bfloat16", dict(causal=True, softcap=20.0)),
        (1, 64, 8, 2, 2, hd, "bfloat16", dict(causal=True, window=4)),
        (2, 1000, 1000, 32, 8, hd, "bfloat16", dict(causal=True)),
    )],
    # bf16 at no multiple of 8: mma
    (1, 256, 256, 4, 2, 100, "bfloat16", dict(causal=True)),
    (1, 96, 160, 4, 2, 116, "bfloat16", dict(causal=False)),
    (1, 200, 300, 4, 2, 20, "float32", dict(causal=True)),            # hd 20, T != S
    (1, 300, 200, 4, 1, 256, "bfloat16", dict(causal=True)),          # the widest hd
    # bf16 at head_dim 64 / 128: the wgmma route
    (1, 128, 128, 4, 4, 64, "bfloat16", dict(causal=True)),           # MHA
    (2, 128, 128, 4, 2, 64, "bfloat16", dict(causal=False)),          # GQA
    (1, 256, 256, 8, 1, 64, "bfloat16", dict(causal=True)),           # MQA
    (1, 256, 256, 4, 4, 64, "bfloat16", dict(causal=True, window=32)),
    (1, 256, 256, 4, 4, 64, "bfloat16", dict(causal=True, window=96)),
    (1, 128, 128, 2, 2, 64, "bfloat16", dict(causal=True, softcap=20.0)),
    (1, 1000, 1000, 4, 2, 64, "bfloat16", dict(causal=True)),         # ragged
    (1, 96, 160, 4, 2, 64, "bfloat16", dict(causal=False)),           # T != S
    (1, 96, 160, 4, 2, 128, "bfloat16", dict(causal=True)),
    (1, 64, 8, 2, 2, 64, "bfloat16", dict(causal=True, window=4)),    # empty rows
    (2, 1000, 1000, 8, 2, 128, "bfloat16", dict(causal=True)),
    # more work tiles than SMs: each persistent block walks several
    (2, 1000, 1000, 32, 8, 64, "bfloat16", dict(causal=True, window=96)),
    (4, 300, 700, 32, 4, 64, "bfloat16", dict(causal=False)),
    (4, 512, 8, 32, 8, 64, "bfloat16", dict(causal=True, window=4)),
    (3, 1000, 1000, 16, 4, 128, "bfloat16", dict(causal=True, softcap=20.0)),
    (4, 1024, 1024, 32, 8, 64, "bfloat16", dict(causal=True)),        # the slice
    # served shapes: chatglm3-6b's 16 query heads a KV head (wgmma in bf16,
    # mma in f32) and zamba2-7b's MHA at hd 112 (wgmma)
    (4, 1024, 1024, 32, 2, 128, "bfloat16", dict(causal=True)),
    (4, 1024, 1024, 32, 2, 128, "float32", dict(causal=True)),
    (4, 1024, 1024, 32, 32, 112, "bfloat16", dict(causal=True)),
    # head_dims above 256: the wide route
    *[case for hd in (320, 512) for dt in ("float32", "bfloat16") for case in (
        (1, 300, 300, 4, 2, hd, dt, dict(causal=True, window=96, softcap=20.0)),
        (1, 96, 160, 4, 2, hd, dt, dict(causal=False)),             # T != S
        (1, 64, 8, 2, 2, hd, dt, dict(causal=True, window=4)),       # empty rows
    )],
    (1, 40, 40, 2, 1, 257, "float32", dict(causal=True)),
    # the encdec and vlm shapes, bf16 (wgmma) and f32 (mma)
    *[(B, S, T, H, KV, hd, dt, dict(causal=causal))
      for B, S, T, H, KV, hd, causal in ENCDEC_VLM_SHAPES.values()
      for dt in ("bfloat16", "float32")],
    # padded widths (257: no multiple of 8), more than 512 columns (two and
    # eight column slices of the grid), each in f32 and bf16
    *[case for dt in ("float32", "bfloat16") for case in (
        *[case for hd in (257, 384) for case in (
            (1, 300, 300, 4, 2, hd, dt, dict(causal=True, window=96, softcap=20.0)),
            (1, 96, 160, 4, 2, hd, dt, dict(causal=False)),         # T != S
        )],
        (1, 200, 200, 4, 2, 1024, dt, dict(causal=True)),
        (1, 64, 64, 2, 1, 4096, dt, dict(causal=True)),
    )],
])
def test_kernel_matches_plain(cuda, B, S, T, H, KV, hd, dtype, kw):
    td = getattr(torch, dtype)
    q, k, v = _qkv(cuda, td, B, S, T, H, KV, hd)
    counters = (tfa.flash_attention, tfa.flash_attention_wgmma,
                tfa.flash_attention_mma, tfa.flash_attention_wide)
    before = [c.launches for c in counters]
    got = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    route = tfa.route(td, hd)
    assert route == ("wide" if hd > 256 else
                     "wgmma" if dtype == "bfloat16" and (
                         hd == 64 or (72 <= hd <= 128 and hd % 8 == 0)) else "mma")
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [1, int(route == "wgmma"), int(route == "mma"), int(route == "wide")]
    assert got.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), tref(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)


def test_kernel_reads_strided_layout(cuda):
    """q/k/v as views of one fused projection (heads not contiguous)."""
    rng = np.random.default_rng(10)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 130, 6 * 32), dtype=np.float32)).to(cuda)
    q = qkv[..., :4 * 32].reshape(2, 130, 4, 32)
    k = qkv[..., 4 * 32:5 * 32].reshape(2, 130, 1, 32)
    v = qkv[..., 5 * 32:].reshape(2, 130, 1, 32)
    assert not q.is_contiguous()
    got = tops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, tref(q, k, v, causal=True),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("hd", [112, 120])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_mma_kernel_reads_strided_layout_at_wide_head_dims(cuda, hd, dtype, tol):
    """q/k/v as views of one fused projection at zamba2-7b's and
    h2o-danube's head dims, through the mma kernel (the route of f32; bf16
    there goes to the wgmma route, which the tests below hold)."""
    rng = np.random.default_rng(14)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, 130, 6 * hd), dtype=np.float32)).to(cuda, getattr(torch, dtype))
    q = qkv[..., :4 * hd].reshape(2, 130, 4, hd)
    k = qkv[..., 4 * hd:5 * hd].reshape(2, 130, 1, hd)
    v = qkv[..., 5 * hd:].reshape(2, 130, 1, hd)
    assert not q.is_contiguous()
    before = tfa.flash_attention_mma.launches
    got = tfa.flash_attention_mma(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_mma.launches == before + 1
    torch.testing.assert_close(got.float(), tref(q, k, v, causal=True).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [112, 120])
def test_wgmma_kernel_reads_only_head_dim_columns(cuda, hd):
    """Each head of a fused projection followed by 8 columns of large
    values: the padded instance's tensor maps stop at hd, so the result
    matches the plain version; maps of 128 columns would read those values
    (``chip_smoke.py`` plants that fault and sees it fail)."""
    B, S, H, KV = 2, 200, 4, 2
    rng = np.random.default_rng(17)
    rows = rng.standard_normal((B, S + 1, H + 2 * KV, hd + 8), dtype=np.float32)
    rows[..., hd:] *= 100.0
    rows = torch.from_numpy(rows).to(cuda, torch.bfloat16)[:, :S]
    q, k, v = rows[:, :, :H, :hd], rows[:, :, H:H + KV, :hd], rows[:, :, H + KV:, :hd]
    before = tfa.flash_attention_wgmma.launches
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_wgmma.launches == before + 1
    torch.testing.assert_close(got.float(), tref(q, k, v, causal=True).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("hd", [72, 96, 112, 120])
def test_wgmma_kernel_is_deterministic_at_padded_head_dims(cuda, hd):
    """Two calls at a served shape's (B, S, H, KV) give the same bits."""
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 1024, 1024, 32, 8, hd)
    first = tops.flash_attention(q, k, v, causal=True)
    assert torch.equal(first, tops.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("hd", [64, 72, 96, 112, 120])
def test_wgmma_kernel_reads_strided_bf16_layout(cuda, hd):
    """bf16 q/k/v as views of one fused projection, on the wgmma route (at
    72..120 its zero-padded hd-128 instance): one launch there, none on the
    mma route."""
    rng = np.random.default_rng(13)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, 130, 6 * hd), dtype=np.float32)).to(cuda, torch.bfloat16)
    q = qkv[..., :4 * hd].reshape(2, 130, 4, hd)
    k = qkv[..., 4 * hd:5 * hd].reshape(2, 130, 1, hd)
    v = qkv[..., 5 * hd:].reshape(2, 130, 1, hd)
    assert not q.is_contiguous()
    before = (tfa.flash_attention_wgmma.launches, tfa.flash_attention_mma.launches)
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_wgmma.launches, tfa.flash_attention_mma.launches) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(got.float(), tref(q, k, v, causal=True).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("hd,full", [(64, 68), (112, 116)])
def test_wgmma_kernel_refuses_strides_tma_cannot_take(cuda, hd, full):
    """A bf16 view at hd 64 or 112 whose heads lie 136 or 232 bytes apart
    (no multiple of 16) raises; it goes to no other route."""
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 64, 64, 4, 4, full)
    q, k, v = (t[..., :hd] for t in (q, k, v))
    counters = (tfa.flash_attention, tfa.flash_attention_wgmma,
                tfa.flash_attention_mma)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="TMA"):
        tops.flash_attention(q, k, v)
    assert [c.launches for c in counters] == before


def test_kernel_rejects_unsupported_head_dim(cuda):
    """Every head_dim from 1 up is taken; 0 raises and launches nothing, the
    mma route alone refuses one above 256, and the wgmma route alone refuses
    bf16 at a head_dim that is no multiple of 8 or above 128."""
    q, k, v = _qkv(cuda, torch.float32, 1, 16, 16, 2, 2, 0)
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="head_dim 0"):
        tops.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before
    q, k, v = _qkv(cuda, torch.float32, 1, 16, 16, 2, 2, 300)
    with pytest.raises(ValueError, match="outside 1..256"):
        tfa.flash_attention_mma(q, k, v)
    for hd in (100, 136):
        q, k, v = _qkv(cuda, torch.bfloat16, 1, 16, 16, 2, 2, hd)
        with pytest.raises(ValueError, match="multiple of 8"):
            tfa.flash_attention_wgmma(q, k, v)
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("hd", [320, 512])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_wide_kernel_reads_strided_layout(cuda, dtype, tol, hd):
    """q/k/v at head_dims 320 and 512 as views of one fused projection,
    one launch on the wide route and none on the others."""
    rng = np.random.default_rng(15)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, 70, 6 * hd), dtype=np.float32)).to(cuda, getattr(torch, dtype))
    q = qkv[..., :4 * hd].reshape(2, 70, 4, hd)
    k = qkv[..., 4 * hd:5 * hd].reshape(2, 70, 1, hd)
    v = qkv[..., 5 * hd:].reshape(2, 70, 1, hd)
    assert not q.is_contiguous()
    counters = (tfa.flash_attention_wgmma, tfa.flash_attention_mma,
                tfa.flash_attention_wide)
    before = [c.launches for c in counters]
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 1]
    torch.testing.assert_close(got.float(), tref(q, k, v, causal=True).float(),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------

def _ssd_inputs(device, B, S, H, P, N, seed=11, slow=False):
    """dt = softplus(randn): a chunk of 128 forgets its carry before the
    next ends. With ``slow`` dt is scaled by 0.02, so that a chunk decays
    the state by ~e^-2 and the carry spans several chunks."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, S, H, P)),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))) * (0.02 if slow else 1.0),
            -np.exp(rng.standard_normal(H) * 0.3),
            rng.standard_normal((B, S, N)) * 0.5,
            rng.standard_normal((B, S, N)) * 0.5)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


@pytest.mark.parametrize("B,S,H,P,N,chunk,slow", [
    (1, 64, 2, 16, 8, 16, False),      # tests/test_kernels.py's shapes
    (2, 128, 4, 32, 16, 32, False),
    (1, 96, 2, 16, 8, 32, False),
    (1, 64, 1, 64, 32, 64, False),
    (2, 1000, 4, 64, 128, 128, False),  # ragged last chunk
    (1, 50, 2, 64, 64, 128, False),     # S < chunk, N = 64
    (2, 256, 4, 32, 16, 16, False),     # the reduced mamba2 shape
    (4, 1024, 32, 64, 128, 128, False),  # the slice
    # slow decay: the state carried across several chunks
    (4, 1024, 32, 64, 128, 128, True),  # the slice
    (1, 4096, 4, 64, 128, 128, True),   # 32 chunks
    (2, 1000, 4, 64, 128, 100, True),   # chunk no multiple of 16, ragged
    (1, 256, 4, 64, 128, 128, True),    # fewer blocks than SMs
    (2, 2048, 32, 64, 128, 128, True),  # more blocks than SMs
    (4, 1024, 112, 64, 64, 128, False),  # zamba2-7b's shape, both decays
    (4, 1024, 112, 64, 64, 128, True),
    # sizes the kernel is not built for: sliced and padded by the wrapper
    *[(1, 300, 4, P, N, chunk, slow) for P, N in ((128, 256), (48, 96))
      for chunk, slow in ((128, False), (256, True))],
    (2, 100, 2, 8, 4, 40, True),
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk, slow):
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, N, slow=slow)
    before = tssd.ssd_scan.launches
    got, state = tops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    p_cuts, n_cuts, _ = tssd.slice_plan(P, N, chunk)
    assert tssd.ssd_scan.launches == before + len(p_cuts) * len(n_cuts)
    want, want_state = ssd_scan_ref(xh, dt, A, Bm, Cm, return_state=True)
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(state, want_state, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_kernel_reads_strided_layout(cuda):
    """x and B/C as views of one fused projection (not contiguous)."""
    B, S, H, P, N = 2, 70, 2, 32, 16
    rng = np.random.default_rng(12)
    fused = torch.from_numpy(rng.standard_normal(
        (B, S, H * P + 2 * N), dtype=np.float32)).to(cuda)
    xh = fused[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = fused[..., H * P:H * P + N], fused[..., H * P + N:]
    _, dt, A, _, _ = _ssd_inputs(cuda, B, S, H, P, N)
    assert not xh.is_contiguous() and not Bm.is_contiguous()
    got = tops.ssd_scan(xh, dt, A, Bm, Cm, chunk=32)
    torch.testing.assert_close(got, ssd_scan_ref(xh, dt, A, Bm, Cm),
                               rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    """Any P, N and chunk are taken (sliced or padded); other types, a
    tensor off the card and a chunk of 0 raise."""
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 16, 2, 16, 8)
    with pytest.raises(TypeError, match="float32"):
        tssd.ssd_scan(xh.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_scan(xh, dt, A.cpu(), Bm, Cm)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan(xh, dt, A, Bm, Cm, chunk=0)
    got = tssd.ssd_scan(xh[..., :8], dt, A, Bm, Cm, chunk=256)
    torch.testing.assert_close(got, ssd_scan_ref(xh[..., :8], dt, A, Bm, Cm),
                               rtol=SSD_TOL, atol=SSD_TOL)


# ---------------------------------------------------------------------------
# SSD backward
# ---------------------------------------------------------------------------

def _close_scaled(got, want, tol=SSD_BWD_TOL):
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("B,S,H,P,N,chunk,slow", [
    (1, 64, 2, 16, 8, 16, False),
    (2, 128, 4, 32, 16, 32, True),
    (1, 50, 2, 64, 64, 128, False),     # S < chunk
    (2, 1000, 4, 64, 128, 128, True),   # ragged last chunk
    (2, 1000, 4, 64, 128, 100, True),   # chunk no multiple of 16
    (2, 256, 4, 32, 16, 16, False),     # the reduced mamba2 shape
    (1, 300, 4, 128, 256, 256, True),   # sliced, chunk cut
    (1, 300, 4, 48, 96, 128, False),    # padded
    (2, 100, 2, 8, 4, 40, True),
    *SSD_BWD_GROUP_CASES,
])
def test_ssd_backward_kernel_matches_plain(cuda, B, S, H, P, N, chunk, slow):
    ins = _ssd_inputs(cuda, B, S, H, P, N, slow=slow)
    dy = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (B, S, H, P)).astype(np.float32)).to(cuda)
    before = tssd.ssd_scan_bwd.launches
    got = tops.ssd_scan_bwd(*ins, dy, chunk=chunk)
    torch.cuda.synchronize()
    p_cuts, n_cuts, _ = tssd.slice_plan(P, N, chunk)
    assert tssd.ssd_scan_bwd.launches == before + len(p_cuts) * len(n_cuts)
    for g, w in zip(got, ssd_scan_bwd_ref(*ins, dy, chunk=chunk)):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close_scaled(g, w)


def test_ssd_backward_kernel_is_deterministic(cuda):
    """Every sum in a fixed order, no atomics: two calls, the same bits."""
    ins = _ssd_inputs(cuda, 2, 512, 8, 64, 128, slow=True)
    dy = torch.randn(ins[0].shape, device=cuda)
    first = tops.ssd_scan_bwd(*ins, dy, chunk=128)
    assert all(torch.equal(a, b) for a, b in zip(first, tops.ssd_scan_bwd(*ins, dy, chunk=128)))


@pytest.mark.parametrize("B,S,H,P,N,chunk,slow", SSD_BWD_GROUP_CASES)
def test_ssd_backward_kernel_groups_heads(cuda, B, S, H, P, N, chunk, slow):
    """At these shapes the kernel takes more than one head a block in a
    pass (chip_smoke.py's SSD_BWD_GROUP_CASES), and two calls still give
    the same bits."""
    assert tssd.bwd_groups(cuda, B, S, H, P, N, chunk)[:2] != (1, 1)
    ins = _ssd_inputs(cuda, B, S, H, P, N, slow=slow)
    dy = torch.randn(ins[0].shape, device=cuda)
    first = tops.ssd_scan_bwd(*ins, dy, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(first, tops.ssd_scan_bwd(*ins, dy, chunk=chunk)))


def test_ssd_backward_kernel_refuses_what_it_does_not_take(cuda):
    xh, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 16, 2, 16, 8)
    with pytest.raises(TypeError, match="float32"):
        tssd.ssd_scan_bwd(xh, dt, A, Bm, Cm, xh.bfloat16())
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_scan_bwd(xh, dt, A, Bm.cpu(), Cm, xh)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan_bwd(xh, dt, A, Bm, Cm, xh, chunk=0)
    with pytest.raises(ValueError, match="shaped as xh"):
        tssd.ssd_scan_bwd(xh, dt, A, Bm, Cm, xh[:, :8])


@pytest.mark.parametrize("arch,over", [("mamba2-370m", {}),
                                       ("zamba2-7b", dict(num_layers=7, hybrid_attn_period=3))],
                         ids=["ssm", "hybrid_tail"])
def test_ssm_training_step_on_card_matches_cpu(cuda, arch, over):
    """One loss and backward of a reduced f32 model on the card (the SSD
    scan and its backward through their kernels, twice and once a Mamba
    block with remat) against the same step on the CPU (the plain
    versions): the loss and every gradient leaf."""
    from repro_torch.bridge import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(arch).reduced(dtype="float32", **over)
    params = LM(cfg, device="cpu").init(0, param_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 100)))
    out = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_(True) for _, t in named_leaves(params)]
        tree = _tree(dict(zip([p for p, _ in named_leaves(params)], leaves)))
        batch = {"tokens": tokens.to(dev), "labels": tokens.roll(-1, 1).to(dev)}
        before = (tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches)
        loss, _ = LM(cfg, device=dev, remat=True).loss(tree, batch)
        grads = torch.autograd.grad(loss, leaves)
        launched = (tssd.ssd_scan.launches - before[0], tssd.ssd_scan_bwd.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (2 * cfg.num_layers, cfg.num_layers))
        out[str(dev)] = (loss.detach().cpu(), [g.cpu() for g in grads])
    (cpu_loss, cpu_grads), (card_loss, card_grads) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(card_loss, cpu_loss, rtol=1e-5, atol=1e-5)
    for (path, _), g, w in zip(named_leaves(params), card_grads, cpu_grads):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=str(path))


# ---------------------------------------------------------------------------
# the collective executor's stacked backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["all_gather", "reduce_scatter", "all_reduce", "all_to_all"])
@pytest.mark.parametrize("fabric", ["ring8", "mp222"])
def test_stacked_collective_on_card_equals_cpu(cuda, fabric, kind):
    """Every step of a round is an elementwise f32 copy or add in the
    program's order, so the card gives the CPU's bits."""
    from repro_torch.comms import primitives
    from repro_torch.core import CollectiveRequest
    from repro_torch.topology import ring
    from repro_torch.topology.generators import multi_pod

    topo = (ring(8, bidirectional=True) if fabric == "ring8" else
            multi_pod(2, 2, 2, unit_links=True, dci_ports_per_pod=2))
    req = CollectiveRequest(kind, group=tuple(range(8)),
                            hierarchy="never" if fabric == "ring8" else "always")
    rng = np.random.default_rng(16)
    shape = {"all_gather": (8, 1000), "all_reduce": (8, 8 * 1000)}.get(kind, (8, 8, 1000))
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    fn = getattr(primitives, f"pccl_{kind}")
    want = fn(x, topo, req)
    got = fn(x.to(cuda), topo, req)
    assert got.is_cuda
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# the backward kernel: the case grid of tests/test_kernels.py at the widths
# the training path uses (hd 32, 64, 128), both types, and the edges
BWD_CASES = [
    *[case for hd in (32, 64, 128) for dt in ("float32", "bfloat16") for case in (
        (1, 192, 192, 4, 4, hd, dt, dict(causal=True)),               # MHA, S=192
        (2, 192, 192, 4, 2, hd, dt, dict(causal=False)),              # GQA
        (1, 192, 192, 8, 1, hd, dt, dict(causal=True)),               # MQA
        (1, 192, 192, 4, 2, hd, dt, dict(causal=True, window=32)),
        (1, 192, 192, 4, 2, hd, dt, dict(causal=True, window=96)),
        (1, 192, 192, 4, 2, hd, dt, dict(causal=True, softcap=20.0)),
    )],
    (1, 96, 160, 4, 2, 64, "float32", dict(causal=False)),            # T != S
    (1, 64, 8, 2, 2, 32, "bfloat16", dict(causal=True, window=4)),    # empty rows
    (1, 300, 200, 4, 2, 20, "float32", dict(causal=True)),            # hd padded to 32
    (1, 130, 130, 4, 2, 100, "bfloat16", dict(causal=True, window=50, softcap=20.0)),
    (4, 1024, 1024, 32, 8, 64, "bfloat16", dict(causal=True)),        # llama's training shape
    # the encdec and vlm training shapes: bf16, and f32 at whisper's
    *[(B, S, T, H, KV, hd, dt, dict(causal=causal))
      for B, S, T, H, KV, hd, causal in ENCDEC_VLM_SHAPES.values()
      for dt in (("bfloat16", "float32") if H == 16 else ("bfloat16",))],
]


@pytest.mark.parametrize("B,S,T,H,KV,hd,dtype,kw", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, B, S, T, H, KV, hd, dtype, kw):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, dt, B, S, T, H, KV, hd, seed=11)
    o = tref(q, k, v, **kw)
    do = torch.from_numpy(np.random.default_rng(12).standard_normal(
        q.shape, dtype=np.float32)).to(cuda, dt)
    before = tfa.flash_attention_bwd.launches
    got = tops.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, o, do, **kw)):
        assert g.dtype == dt and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_is_deterministic(cuda, dtype):
    """Two calls on the same GQA causal inputs give the same bits: no
    atomics, and every sum runs in a fixed order whatever order the blocks
    run in (the DP ranks' params stay equal bit for bit on it)."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, dt, 2, 300, 300, 8, 2, 64, seed=13)
    o = tref(q, k, v, causal=True)
    do = torch.randn_like(q)
    first = tops.flash_attention_bwd(q, k, v, o, do, causal=True)
    second = tops.flash_attention_bwd(q, k, v, o, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# the backward's wgmma route (csrc/flash_attention_bwd_wgmma.cu): the bf16
# cases of BWD_CASES at head_dim 64 and 128, where BWD_ROUTES sends the call
WGMMA_BWD_CASES = [c for c in BWD_CASES if c[6] == "bfloat16" and c[5] in (64, 128)]


@pytest.mark.parametrize("B,S,T,H,KV,hd,dtype,kw", WGMMA_BWD_CASES)
def test_wgmma_backward_matches_plain_and_the_mma_route(cuda, B, S, T, H, KV, hd, dtype, kw):
    """The router sends the call to the wgmma route and counts it there; its
    gradients and the mma route's each match the plain version, and each
    other, within BF16_TOL."""
    q, k, v = _qkv(cuda, torch.bfloat16, B, S, T, H, KV, hd, seed=21)
    o = tref(q, k, v, **kw)
    do = torch.from_numpy(np.random.default_rng(22).standard_normal(
        q.shape, dtype=np.float32)).to(cuda, torch.bfloat16)
    before = (tfa.flash_attention_bwd_wgmma.launches, tfa.flash_attention_bwd_mma.launches)
    got = tops.flash_attention_bwd(q, k, v, o, do, **kw)
    assert (tfa.flash_attention_bwd_wgmma.launches,
            tfa.flash_attention_bwd_mma.launches) == (before[0] + 1, before[1])
    mma = tfa.flash_attention_bwd_mma(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    for g, m, w in zip(got, mma, flash_attention_bwd_ref(q, k, v, o, do, **kw)):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), rtol=BF16_TOL, atol=BF16_TOL)
        torch.testing.assert_close(m.float(), w.float(), rtol=BF16_TOL, atol=BF16_TOL)
        torch.testing.assert_close(g.float(), m.float(), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_backward_is_deterministic(cuda, hd):
    """Two calls of the wgmma route on llama's training shape (and at hd
    128) give the same bits: no atomics, every sum in a fixed order."""
    q, k, v = _qkv(cuda, torch.bfloat16, 4, 1024, 1024, 32, 8, hd, seed=23)
    o = tfa.flash_attention(q, k, v, causal=True)
    do = torch.randn_like(q)
    first = tfa.flash_attention_bwd_wgmma(q, k, v, o, do, causal=True)
    second = tfa.flash_attention_bwd_wgmma(q, k, v, o, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wgmma_backward_refuses_on_the_card(cuda):
    """On the card too, the wgmma route takes bf16 at hd 64 and 128 and
    views TMA can read only; nothing falls back to the mma route."""
    q, k, v = _qkv(cuda, torch.float32, 1, 16, 16, 2, 1, 64)
    with pytest.raises(ValueError, match="bf16 at head_dim 64 or 128"):
        tfa.flash_attention_bwd_wgmma(q, k, v, q, q)
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 16, 16, 2, 1, 96)
    with pytest.raises(ValueError, match="bf16 at head_dim 64 or 128"):
        tfa.flash_attention_bwd_wgmma(q, k, v, q, q)
    q = _qkv(cuda, torch.bfloat16, 1, 16, 16, 2, 1, 65)[0][..., :64]
    k = _qkv(cuda, torch.bfloat16, 1, 16, 16, 2, 1, 64)[1]
    with pytest.raises(ValueError, match="16-byte multiples"):
        tfa.flash_attention_bwd_wgmma(q, k, k, q, q)


def test_backward_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 16, 16, 2, 1, 256)
    with pytest.raises(ValueError, match="head_dim 1..128"):
        tops.flash_attention_bwd(q, k, v, q, q)
    q, k, v = _qkv(cuda, torch.float32, 1, 16, 16, 2, 1, 64)
    with pytest.raises(ValueError, match="must be like q"):
        tfa.flash_attention_bwd(q, k, v, q.bfloat16(), q)


def test_training_step_through_both_kernels(cuda):
    """One loss and backward of a reduced bf16 model on the card: the forward
    and backward kernels both launch, and the gradients match the same step
    through the plain versions."""
    from repro_torch.bridge import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config("llama3.2-1b").reduced(num_layers=2, head_dim=64, d_model=256)
    params = LM(cfg, device=cuda).init(0, param_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 128)))
    batch = {"tokens": tokens.to(cuda), "labels": tokens.roll(-1, 1).to(cuda)}
    grads = {}
    for name, kw in (("kernel", {}), ("plain", dict(attention=tref,
                                                    attention_bwd=flash_attention_bwd_ref))):
        leaves = [t.detach().clone().requires_grad_(True) for _, t in named_leaves(params)]
        tree = dict(zip([p for p, _ in named_leaves(params)], leaves))
        fwd, bwd = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
        loss, _ = LM(cfg, device=cuda, remat=True, **kw).loss(_tree(tree), batch)
        grads[name] = torch.autograd.grad(loss, leaves)
        launched = (tfa.flash_attention.launches - fwd, tfa.flash_attention_bwd.launches - bwd)
        assert launched == ((4, 2) if name == "kernel" else (0, 0))
    for g, w in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(g, w, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("over", [{}, dict(num_layers=7, hybrid_attn_period=3)],
                         ids=["no_tail", "tail"])
def test_reduced_hybrid_on_card_matches_cpu(cuda, over):
    """The reduced zamba2 in f32 (the attention kernel once a group, the
    SSD kernel once a Mamba block) on the card against the same params on
    the CPU (the plain versions): forward logits and every leaf of the
    prefilled cache."""
    from repro_torch.bridge import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config("zamba2-7b").reduced(dtype="float32", **over)
    cpu_lm, card_lm = LM(cfg, device="cpu"), LM(cfg, device=cuda)
    params = cpu_lm.init(0)
    card_params = _tree({path: t.to(cuda) for path, t in named_leaves(params)})
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 100)))
    groups = cfg.num_layers // cfg.hybrid_attn_period
    with torch.inference_mode():
        before = (tfa.flash_attention.launches, tssd.ssd_scan.launches)
        got = card_lm.forward_logits(card_params, tokens.to(cuda))
        torch.cuda.synchronize()
        assert (tfa.flash_attention.launches - before[0],
                tssd.ssd_scan.launches - before[1]) == (groups, cfg.num_layers)
        torch.testing.assert_close(got.cpu(), cpu_lm.forward_logits(params, tokens),
                                   rtol=1e-4, atol=1e-4)
        got_log, got_cache = card_lm.prefill(card_params, tokens.to(cuda), max_seq=104)
        want_log, want_cache = cpu_lm.prefill(params, tokens, max_seq=104)
    torch.testing.assert_close(got_log.cpu(), want_log, rtol=1e-4, atol=1e-4)
    want = dict(named_leaves(want_cache))
    for path, leaf in named_leaves(got_cache):
        torch.testing.assert_close(leaf.cpu(), want[path], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_reduced_encdec_vlm_on_card_matches_cpu(cuda, arch):
    """The reduced whisper (encoder, decoder self- and cross-attention
    through the kernel) and llava (patches ahead of the tokens) in f32 on
    the card against the same params on the CPU: forward logits, the
    prefilled cache (whisper's cross k/v included), a decode step, and the
    loss with every gradient leaf through the forward and backward
    kernels."""
    from repro_torch.bridge import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import stub_inputs
    from repro_torch.models import LM

    cfg = get_config(arch).reduced(dtype="float32", encoder_seq=40, num_patches=37)
    cpu_lm, card_lm = LM(cfg, device="cpu"), LM(cfg, device=cuda)
    params = cpu_lm.init(0)
    card_params = _tree({path: t.to(cuda) for path, t in named_leaves(params)})
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 60)))
    stub = {k: torch.from_numpy(v) for k, v in stub_inputs(cfg, 2, 5).items()}
    card_stub = {k: v.to(cuda) for k, v in stub.items()}
    blocks = (cfg.encoder_layers + 2 * cfg.num_layers if cfg.family == "encdec"
              else cfg.num_layers)
    P = cfg.num_patches if cfg.family == "vlm" else 0
    with torch.inference_mode():
        before = tfa.flash_attention.launches
        got = card_lm.forward_logits(card_params, tokens.to(cuda), **card_stub)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches - before == blocks
        torch.testing.assert_close(got.cpu(), cpu_lm.forward_logits(params, tokens, **stub),
                                   rtol=1e-4, atol=1e-4)
        _, got_cache = card_lm.prefill(card_params, tokens.to(cuda), max_seq=P + 61,
                                       **card_stub)
        _, want_cache = cpu_lm.prefill(params, tokens, max_seq=P + 61, **stub)
        want = dict(named_leaves(want_cache))
        for path, leaf in named_leaves(got_cache):
            torch.testing.assert_close(leaf.cpu(), want[path], rtol=1e-4, atol=1e-4)
        got_step, _ = card_lm.decode_step(card_params, got_cache, tokens[:, 0].to(cuda), P + 60)
        want_step, _ = cpu_lm.decode_step(params, want_cache, tokens[:, 0], P + 60)
        torch.testing.assert_close(got_step.cpu(), want_step, rtol=1e-4, atol=1e-4)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1), **stub}
    grads = {}
    for name, lm, tree, dev in (("cpu", cpu_lm, params, "cpu"),
                                ("card", card_lm, card_params, cuda)):
        leaves = [t.detach().clone().requires_grad_(True) for _, t in named_leaves(tree)]
        loss, _ = lm.loss(_tree(dict(zip([p for p, _ in named_leaves(tree)], leaves))),
                          {k: v.to(dev) for k, v in batch.items()})
        grads[name] = (loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, leaves)])
    torch.testing.assert_close(grads["card"][0], grads["cpu"][0], rtol=1e-4, atol=1e-4)
    for (path, _), g, w in zip(named_leaves(params), grads["card"][1], grads["cpu"][1]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=str(path))


# ---------------------------------------------------------------------------
# the MoE layer and the gradient compression (plain torch on the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,E,E_pad,k,cf,dtype", [
    (2, 1024, 32, 32, 8, 1.25, "float32"),   # granite-1b's routing, two groups
    (4, 1, 32, 32, 8, 1.25, "float32"),      # a decode step: C = 1
    (3, 500, 40, 48, 8, 0.5, "float32"),     # granite-3b's 40 padded to 48; drops
    (2, 256, 32, 32, 8, 1.25, "bfloat16"),   # the served dtype
])
def test_moe_ffn_on_card_matches_cpu(cuda, B, S, E, E_pad, k, cf, dtype):
    """``moe_ffn`` on the card against the CPU from the same weights and
    inputs: the same routes, out within f32 (bf16) rounding of the largest
    |value|, the same aux loss."""
    from repro_torch.models import layers, moe

    d, d_ff = 64, 32
    p = moe.moe_init(torch.Generator().manual_seed(0), d, d_ff, E, E_pad)
    p = layers.cast_params(p, getattr(torch, dtype))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, S, d), dtype=np.float32))
    x = x.to(getattr(torch, dtype))
    out = {}
    for dev in ("cpu", cuda):
        routes = []
        y, aux = moe.moe_ffn({n: t.to(dev) for n, t in p.items()}, x.to(dev), num_experts=E,
                             experts_per_token=k, capacity_factor=cf, routes=routes)
        out[str(dev)] = (y.float().cpu(), aux.cpu(), [(i.cpu(), s.cpu()) for i, s in routes])
    (cy, caux, croutes), (gy, gaux, groutes) = out["cpu"], out[str(cuda)]
    for (ci, cs), (gi, gs) in zip(croutes, groutes):
        assert torch.equal(ci, gi) and torch.equal(cs, gs)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float((gy - cy).abs().max()) <= tol * float(cy.abs().max())
    torch.testing.assert_close(gaux, caux, rtol=1e-5, atol=1e-6)


def test_compression_on_card_equals_cpu(cuda):
    """The four compression functions and the stacked all-reduce's
    residuals on the card give the CPU's bits (each op rounds once, in the
    same order). The mean sums 7 rows, which the card's reduction adds in
    another order than the CPU's: within f32 rounding."""
    from repro_torch.comms import compression as c

    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal((64, 3000), dtype=np.float32))
    g = g * (1.5 ** torch.arange(64.0) / 1e3)[:, None]
    r = torch.from_numpy(rng.standard_normal((64, 3000), dtype=np.float32)) * 0.01
    # 64 scales: CUDA's division by a Python scalar (a product with its
    # reciprocal) missed the CPU's scale by an ulp in about one call in ten
    cases = [(c.ef_int8_compress, (g[i], r[i])) for i in range(64)]
    for fn, args in cases + [(c.topk_compress, (g[2], r[2], 50))]:
        want = fn(*args)
        got = fn(*(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args))
        for w, t in zip(want, got):
            assert torch.equal(t.cpu(), w)
    q, scale, _ = c.ef_int8_compress(g[1], r[1])
    assert torch.equal(c.ef_int8_decompress(q.to(cuda), scale.to(cuda)).cpu(),
                       c.ef_int8_decompress(q, scale))
    vals, idx, _ = c.topk_compress(g[2], r[2], 50)
    assert torch.equal(c.topk_decompress(vals.to(cuda), idx.to(cuda), (3000,)).cpu(),
                       c.topk_decompress(vals, idx, (3000,)))
    want_mean, want_res = c.error_feedback_all_reduce({"g": g[:7]}, {"g": r[:7]})  # dp 7
    mean, res = c.error_feedback_all_reduce({"g": g[:7].to(cuda)}, {"g": r[:7].to(cuda)})
    assert torch.equal(res["g"].cpu(), want_res["g"])
    torch.testing.assert_close(mean["g"].cpu(), want_mean["g"], rtol=1e-6, atol=1e-9)


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def test_quickstart_all_gather_on_card(cuda):
    """quickstart's All-Gather over group (0, 3, 12) of the 4x4 mesh on 16
    ranks stacked on the card, NPU d holding d + 1: every member gathers
    [1, 4, 13] and the 13 other NPUs zeros, bit for bit, as the numpy round
    interpreter does; the same program on the CPU gives the same bits."""
    from repro_torch.comms import interpret_collective, pccl_all_gather
    from repro_torch.core import CollectiveRequest
    from repro_torch.examples.quickstart import GROUP
    from repro_torch.topology import mesh2d

    topo = mesh2d(4, 4)
    req = CollectiveRequest("all_gather", group=GROUP)
    x = (torch.arange(16, dtype=torch.float32) + 1.0)[:, None]
    got = pccl_all_gather(x.to(cuda), topo, req).cpu()
    want = np.zeros((16, 3, 1), np.float32)
    want[list(GROUP)] = [[1.0], [4.0], [13.0]]
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    interp = interpret_collective("all_gather", x.numpy(), topo, req)
    assert np.array_equal(got.numpy().view(np.uint32), interp.view(np.uint32))
    assert torch.equal(got, pccl_all_gather(x, topo, req))


def test_policy_path_bit_equal_at_one_rank(cuda):
    """``LM(policy=)`` on a one-rank NCCL group and a data = 1 x model = 1
    mesh, reduced llama in bf16 at head_dim 64 (the wgmma route): prefill,
    3 decode steps and a training step's loss and every gradient leaf bit
    for bit the same as without the policy."""
    from chip_smoke import one_rank_nccl_group, served_logits, train_grads

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import _batch_for_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.sharding import ShardingPolicy
    from repro_torch.models import LM

    end = one_rank_nccl_group(torch)
    try:
        cfg = get_config("llama3.2-1b").reduced(dtype="bfloat16", head_dim=64)
        pol = ShardingPolicy(make_test_mesh(data=1, model=1), cfg)
        plain, lm = LM(cfg, device=cuda), LM(cfg, device=cuda, policy=pol)
        params = plain.init(0)
        prompts = torch.from_numpy(make_prompts(2, 96, cfg.vocab_size, 0)).to(cuda)
        want = served_logits(torch, plain, params, prompts, 3)[0]
        got = served_logits(torch, lm, pol.param_shardings(params), prompts, 3)[0]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        params = plain.init(0, param_dtype=torch.float32)
        raw = _batch_for_step(0, 0, 2, 96, cfg.vocab_size)
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in raw.items()}
        want_loss, want_grads, _ = train_grads(torch, plain, params, batch)
        got_loss, got_grads, _ = train_grads(torch, lm, pol.param_shardings(params), batch)
        assert torch.equal(got_loss, want_loss)
        assert all(torch.equal(got_grads[k], w) for k, w in want_grads.items())
    finally:
        end()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_padded_model_on_card_matches_unpadded(cuda, arch):
    """6 heads (2 KV heads) padded to 8 by ``pad_heads`` at model = 4 and
    carried by ``pad_head_params`` (the moe family's 6 experts to 8): the
    padded model's prefill and 3 decode steps on the card equal the
    unpadded model's within rel-L2 1e-5 in f32, and the reference's layout
    (pad heads appended) misses it."""
    from repro_torch.bridge import pad_head_params
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.sharding import pad_heads
    from repro_torch.models import LM

    over = dict(num_experts=6) if arch.startswith("granite") else {}
    cfg = get_config(arch).reduced(dtype="float32", num_heads=6, num_kv_heads=2, **over)
    padded = pad_heads(cfg, 4)
    lm, plm = LM(cfg, device=cuda), LM(padded, device=cuda, ep_degree=4)
    params = lm.init(0)
    experts = plm.e_pad if cfg.is_moe else None
    carried = pad_head_params(params, cfg, padded, experts=experts)
    appended = pad_head_params(params, cfg, padded, experts=experts,
                               positions=list(range(cfg.num_heads)))
    prompts = torch.from_numpy(make_prompts(2, 100, cfg.vocab_size, 1)).to(cuda)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    with torch.inference_mode():
        want, cache = lm.prefill(params, prompts, max_seq=103)
        got, pcache = plm.prefill(carried, prompts, max_seq=103)
        assert rel(got, want) <= 1e-5
        assert rel(plm.prefill(appended, prompts)[0], want) > 1e-2
        tok = want.argmax(-1)
        for i in range(3):
            want, cache = lm.decode_step(params, cache, tok, 100 + i)
            got, pcache = plm.decode_step(carried, pcache, tok, 100 + i)
            assert rel(got, want) <= 1e-5
            tok = want.argmax(-1)


def test_bundle_train_step_on_card_matches_cpu(cuda, tmp_path):
    """``launch.steps``' train kind, reduced llama in f32 at accum 2, on a
    one-rank NCCL group (the flash kernels, mma route) against the same
    step on a one-rank gloo group on the CPU (the plain versions), from the
    same params and batch: the loss within 1e-4, every updated leaf's step
    within rel-L2 1e-3 (``hold_update``)."""
    import torch.distributed as dist
    from chip_smoke import one_rank_nccl_group

    import _torch_steps_worker as steps_worker
    from repro_torch.data.pipeline import _batch_for_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import LM

    arch = "llama3.2-1b"
    cfg = steps_worker.reduced_config(arch)
    params = LM(cfg, device="cpu").init(0, param_dtype=torch.float32)
    raw = _batch_for_step(0, 0, 4, 96, cfg.vocab_size)

    def run(device):
        # a copy on either device: the step updates its params in place
        on = {k: v.to(device, copy=True) for k, v in steps_worker.flatten(params).items()}
        batch = {k: torch.from_numpy(v).to(device, torch.int64) for k, v in raw.items()}
        mesh = make_test_mesh(1, 1, device_type=device.type)
        metrics, state = steps_worker.train_once(mesh, arch, 2, steps_worker.unflatten(on),
                                                 batch)
        return metrics, {k: v.detach().cpu().numpy() for k, v in state.items()}

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        want, want_state = run(torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    end = one_rank_nccl_group(torch)
    try:
        got, got_state = run(cuda)
    finally:
        end()
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    old = {f"param/{k}": v.numpy() for k, v in steps_worker.flatten(params).items()}
    steps_worker.hold_update(got_state, want_state, old, 1e-3)


def test_launcher_train_on_card_matches_cpu(cuda, tmp_path):
    """``launch.train.train`` of reduced llama in f32 for 3 steps on the
    card (a one-rank NCCL group it starts itself; the flash kernels, mma
    route) against the same run on the CPU (a one-rank gloo group; the
    plain versions), from the same params: every loss within 1e-4 and
    every gradient norm within 1e-3, relative."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.train import train
    from repro_torch.models import LM

    cfg = get_config("llama3.2-1b").reduced(dtype="float32")
    params = LM(cfg, device="cpu").init(0, param_dtype=torch.float32)
    shape = ShapeSpec("t", 96, 4, "train")
    runs = {}
    for device in ("cpu", "cuda"):  # train places a copy of the params
        runs[device] = train(cfg, shape, steps=3, ckpt_dir=str(tmp_path / device),
                             device=device, params=params, log=lambda line: None)
    want, got = runs["cpu"], runs["cuda"]
    assert got["mesh"].device_type == "cuda" and len(got["loss"]) == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-3)


@pytest.mark.parametrize("case", ["flash_attention bf16", "flash_attention f32 window",
                                  "flash_attention_bwd", "ssd_scan state", "ssd_scan",
                                  "ssd_scan_bwd"])
def test_opcheck_on_card(cuda, case):
    """``torch.library.opcheck`` of the kernels' operators on the card at a
    small shape: the schema, the fake implementation against the kernel's
    outputs, and a trace through the operator."""
    B, S, H, KV, hd = 1, 128, 4, 2, 64
    dtype = torch.bfloat16 if "bf16" in case or "bwd" in case else torch.float32
    q, k, v = _qkv(cuda, dtype, B, S, S, H, KV, hd)
    ops = tops.OPS
    if case.startswith("flash_attention_bwd"):
        o = tops.flash_attention(q, k, v)
        op, args = ops.flash_attention_bwd.default, (q, k, v, o, torch.randn_like(o), True, 0,
                                                     0.0)
    elif case.startswith("flash_attention"):
        op, args = ops.flash_attention.default, (q, k, v, True, 32 * ("window" in case), 0.0)
    else:
        gen = torch.Generator(device=cuda).manual_seed(0)
        Bs, Ss, Hs, P, N = 2, 96, 3, 16, 16
        xh = torch.randn((Bs, Ss, Hs, P), generator=gen, device=cuda)
        dt = torch.nn.functional.softplus(torch.randn((Bs, Ss, Hs), generator=gen, device=cuda))
        A = -torch.rand((Hs,), generator=gen, device=cuda)
        Bm, Cm = (torch.randn((Bs, Ss, N), generator=gen, device=cuda) for _ in range(2))
        if case == "ssd_scan_bwd":
            op, args = ops.ssd_scan_bwd.default, (xh, dt, A, Bm, Cm, torch.randn_like(xh), 32)
        else:
            op, args = ops.ssd_scan.default, (xh, dt, A, Bm, Cm, 32, case.endswith("state"))
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
