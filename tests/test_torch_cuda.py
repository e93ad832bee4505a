"""The port's CUDA kernels against their plain versions, on the card.

Every test is ``cuda``-marked and skips without a card. The file imports no
jax, so it runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref as tref  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402

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
    # head dims only the mma route takes: zamba2-7b's 112, h2o-danube's 120
    *[case for hd in (112, 120) for dt in ("float32", "bfloat16") for case in (
        (1, 1000, 1000, 4, 2, hd, dt, dict(causal=True)),             # ragged, GQA
        (1, 256, 256, 4, 4, hd, dt, dict(causal=True, window=96)),
        (1, 128, 128, 2, 2, hd, dt, dict(causal=True, softcap=20.0)),
        (1, 64, 8, 2, 2, hd, dt, dict(causal=True, window=4)),         # empty rows
    )],
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
    # head_dims above 256: the wide route
    *[case for hd in (320, 512) for dt in ("float32", "bfloat16") for case in (
        (1, 300, 300, 4, 2, hd, dt, dict(causal=True, window=96, softcap=20.0)),
        (1, 96, 160, 4, 2, hd, dt, dict(causal=False)),             # T != S
        (1, 64, 8, 2, 2, hd, dt, dict(causal=True, window=4)),       # empty rows
    )],
    (1, 40, 40, 2, 1, 257, "float32", dict(causal=True)),
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
                     "wgmma" if dtype == "bfloat16" and hd in (64, 128) else "mma")
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
    h2o-danube's head dims, on the mma route."""
    rng = np.random.default_rng(14)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, 130, 6 * hd), dtype=np.float32)).to(cuda, getattr(torch, dtype))
    q = qkv[..., :4 * hd].reshape(2, 130, 4, hd)
    k = qkv[..., 4 * hd:5 * hd].reshape(2, 130, 1, hd)
    v = qkv[..., 5 * hd:].reshape(2, 130, 1, hd)
    assert not q.is_contiguous()
    before = tfa.flash_attention_mma.launches
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_mma.launches == before + 1
    torch.testing.assert_close(got.float(), tref(q, k, v, causal=True).float(),
                               rtol=tol, atol=tol)


def test_wgmma_kernel_reads_strided_bf16_layout(cuda):
    """bf16 q/k/v as views of one fused projection, on the wgmma route."""
    rng = np.random.default_rng(13)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, 130, 6 * 64), dtype=np.float32)).to(cuda, torch.bfloat16)
    q = qkv[..., :4 * 64].reshape(2, 130, 4, 64)
    k = qkv[..., 4 * 64:5 * 64].reshape(2, 130, 1, 64)
    v = qkv[..., 5 * 64:].reshape(2, 130, 1, 64)
    assert not q.is_contiguous()
    before = tfa.flash_attention_wgmma.launches
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_wgmma.launches == before + 1
    torch.testing.assert_close(got.float(), tref(q, k, v, causal=True).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_wgmma_kernel_refuses_strides_tma_cannot_take(cuda):
    """A bf16 hd-64 view whose heads lie 136 bytes apart raises; it goes to
    no other route."""
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 64, 64, 4, 4, 68)
    q, k, v = (t[..., :64] for t in (q, k, v))
    counters = (tfa.flash_attention, tfa.flash_attention_wgmma,
                tfa.flash_attention_mma)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="TMA"):
        tops.flash_attention(q, k, v)
    assert [c.launches for c in counters] == before


def test_kernel_rejects_unsupported_head_dim(cuda):
    """Every head_dim from 1 up is taken; 0 raises and launches nothing, and
    the mma route alone refuses one above 256."""
    q, k, v = _qkv(cuda, torch.float32, 1, 16, 16, 2, 2, 0)
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="head_dim 0"):
        tops.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before
    q, k, v = _qkv(cuda, torch.float32, 1, 16, 16, 2, 2, 300)
    with pytest.raises(ValueError, match="outside 1..256"):
        tfa.flash_attention_mma(q, k, v)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_wide_kernel_reads_strided_layout(cuda, dtype, tol):
    """q/k/v at head_dim 320 as views of one fused projection."""
    hd = 320
    rng = np.random.default_rng(15)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, 70, 6 * hd), dtype=np.float32)).to(cuda, getattr(torch, dtype))
    q = qkv[..., :4 * hd].reshape(2, 70, 4, hd)
    k = qkv[..., 4 * hd:5 * hd].reshape(2, 70, 1, hd)
    v = qkv[..., 5 * hd:].reshape(2, 70, 1, hd)
    before = tfa.flash_attention_wide.launches
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_wide.launches == before + 1
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
