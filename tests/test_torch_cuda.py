"""The port's CUDA kernel against its plain version, on the card.

Every test is ``cuda``-marked and skips without a card. The file imports no
jax, so it runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref as tref  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2

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
    (2, 1000, 1000, 8, 2, 128, "bfloat16", dict(causal=True)),
    (4, 1024, 1024, 32, 8, 64, "bfloat16", dict(causal=True)),        # the slice
])
def test_kernel_matches_plain(cuda, B, S, T, H, KV, hd, dtype, kw):
    td = getattr(torch, dtype)
    q, k, v = _qkv(cuda, td, B, S, T, H, KV, hd)
    before = tfa.flash_attention.launches
    got = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
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


def test_kernel_rejects_unsupported_head_dim(cuda):
    q, k, v = _qkv(cuda, torch.float32, 1, 16, 16, 2, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_attention(q, k, v)
