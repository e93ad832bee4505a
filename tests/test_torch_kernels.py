"""The port's flash attention against the JAX package's, on the same inputs.

On the CPU the port's entry point runs the kernel's plain version; it is
held against the Pallas kernel (interpret mode, as tests/test_kernels.py
runs it) and the jnp oracle, at that file's shapes and tolerances. The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref as tref  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv_np(seed, B, S, H, KV, hd, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32))


def _both(arrs, dtype="float32"):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check(seed, B, S, H, KV, hd, tol=F32_TOL, dtype="float32", T=None, **kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv_np(seed, B, S, H, KV, hd, T=T), dtype)
    tfa.flash_attention.launches = 0
    got = tops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert tfa.flash_attention.launches == 0  # CPU tensors never launch
    pallas = jops.flash_attention(jq, jk, jv, block_q=64, block_kv=64, **kw)
    oracle = jref(jq, jk, jv, **kw)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 32),   # MHA
    (2, 128, 4, 2, 32),   # GQA 2:1
    (1, 256, 8, 1, 16),   # MQA
    (1, 192, 2, 2, 64),   # non-pow2 seq
])
@pytest.mark.parametrize("causal", [True, False])
def test_shapes_causal(B, S, H, KV, hd, causal):
    _check(0, B, S, H, KV, hd, causal=causal)


@pytest.mark.parametrize("window", [32, 96])
def test_sliding_window(window):
    _check(1, 1, 256, 4, 4, 32, causal=True, window=window)


def test_softcap():
    _check(2, 1, 128, 2, 2, 32, causal=True, softcap=20.0)


def test_bf16():
    _check(3, 1, 128, 4, 2, 32, tol=BF16_TOL, dtype="bfloat16", causal=True)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("B,S,H,KV,hd,T,kw", [
    (1, 128, 4, 4, 112, None, dict(causal=True)),               # zamba2-7b's hd, MHA
    (1, 256, 4, 2, 120, None, dict(causal=True, window=32)),    # h2o-danube's hd, GQA
    (1, 128, 2, 2, 20, None, dict(causal=True, softcap=20.0)),  # no multiple of 8
    (1, 96, 4, 2, 200, 160, dict(causal=False)),                # wider than 128, T != S
    (1, 128, 4, 2, 72, None, dict(causal=True, softcap=20.0)),  # the narrowest padded
    (1, 96, 4, 4, 96, 160, dict(causal=False)),                 # T != S, MHA
])
def test_head_dims_of_the_mma_route(B, S, H, KV, hd, T, kw, dtype, tol):
    """Head dims other than 64 and 128 (on the card: the mma route in f32
    and at 20 and 200, the wgmma route's zero-padded hd-128 instance in
    bf16 at the multiples of 8 from 72 to 120), held against the Pallas
    kernel and the oracle."""
    _check(9, B, S, H, KV, hd, tol=tol, dtype=dtype, T=T, **kw)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("hd", [257, 320, 512])
@pytest.mark.parametrize("B,S,H,KV,T,kw", [
    (1, 128, 2, 2, None, dict(causal=True)),                           # MHA
    (1, 128, 4, 2, None, dict(causal=True, window=96, softcap=20.0)),  # GQA
    (1, 96, 4, 2, 128, dict(causal=False)),                            # T != S
])
def test_head_dims_of_the_wide_route(B, S, H, KV, T, kw, hd, dtype, tol):
    """Head dims above 256, which only the wide route takes on the card
    (257 pads to no multiple of 8), held against the Pallas kernel and the
    oracle."""
    _check(12, B, S, H, KV, hd, tol=tol, dtype=dtype, T=T, **kw)


def test_block_shape_independence():
    """The port has no block shape; it matches the Pallas kernel at two."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv_np(4, 1, 256, 2, 2, 32))
    got = _np(tops.flash_attention(tq, tk, tv, causal=True))
    for bq, bkv in ((64, 128), (128, 64)):
        want = jops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                    block_kv=bkv)
        np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)


def test_ragged_and_cross_lengths():
    """S=1000 (no power-of-two factor the Pallas walk would need) and T != S
    go through the plain version; held against the jnp oracle."""
    for S, T, causal in ((1000, 1000, True), (96, 160, False), (160, 96, True)):
        arrs = _qkv_np(5, 1, S, 2, 1, 16, T=T)
        (jq, jk, jv), (tq, tk, tv) = _both(arrs)
        got = tops.flash_attention(tq, tk, tv, causal=causal)
        np.testing.assert_allclose(_np(got), _np(jref(jq, jk, jv, causal=causal)),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_fully_masked_rows_are_zero():
    """A query that sees no key (its window lies past a short T) gives 0."""
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(6, 1, 64, 2, 2, 16, T=8))
    out = tref(q, k, v, causal=True, window=4)
    assert torch.all(out[:, 11:] == 0) and torch.all(torch.isfinite(out))
    assert torch.all(out[:, :11].abs().sum(-1) > 0)


def test_fully_masked_rows_are_zero_at_a_wide_head_dim():
    """The same at head_dim 320, the wide route's: rows 11.. see no key."""
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(13, 1, 64, 2, 2, 320, T=8))
    out = tops.flash_attention(q, k, v, causal=True, window=4)
    assert torch.all(out[:, 11:] == 0) and torch.all(torch.isfinite(out))
    assert torch.all(out[:, :11].abs().sum(-1) > 0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "group", "device"])
def test_dispatch_rejects(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(7, 1, 16, 4, 2, 16))
    if bad == "shape":
        k = k[:, :, :, :8]
    elif bad == "dtype":
        v = v.to(torch.bfloat16)
    elif bad == "group":
        q = q[:, :, :3]
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises((ValueError, TypeError)):
        tops.flash_attention(q, k, v)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(8, 1, 16, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# The route table and the CUDA wrappers' checks (no card needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,want", [
    (torch.float32, 16, "mma"),
    (torch.float32, 32, "mma"),
    (torch.float32, 64, "mma"),      # llama3.2-1b served in f32: 3xTF32
    (torch.float32, 128, "mma"),
    (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"),     # the training slice's tiny and 10m models
    (torch.bfloat16, 64, "wgmma"),   # llama3.2-1b
    (torch.bfloat16, 128, "wgmma"),  # chatglm3, internlm2, llava
    *[(dtype, hd, "mma") for dtype in (torch.float32, torch.bfloat16)
      for hd in (8, 20, 40, 200, 256)],
    # bf16 at the multiples of 8 from 72 to 120: wgmma (the hd-128 instance,
    # TMA zero-filling the columns past hd); 112: zamba2-7b, 120: h2o-danube
    *[(dtype, hd, "wgmma" if dtype == torch.bfloat16 else "mma")
      for dtype in (torch.float32, torch.bfloat16) for hd in (112, 120)],
    *[(torch.bfloat16, hd, "wgmma") for hd in (72, 80, 96)],
    # no multiple of 8 (TMA needs 16-byte head strides): mma
    *[(torch.bfloat16, hd, "mma") for hd in (100, 116)],
    # above 256: the wide kernel, as the reference's kernel takes any head_dim
    *[(dtype, hd, "wide") for dtype in (torch.float32, torch.bfloat16)
      for hd in (257, 300, 320, 512, 4096)],
])
def test_route_table(dtype, hd, want):
    assert tfa.route(dtype, hd) == want
    assert tfa.ROUTES[(dtype, hd)] == want


@pytest.mark.parametrize("dtype,hd,exc,match", [
    (torch.float32, 0, ValueError, "head_dim 0 is not a positive integer"),
    (torch.bfloat16, 0, ValueError, "head_dim 0 is not a positive integer"),
    (torch.float32, -3, ValueError, "head_dim -3 is not a positive integer"),
    (torch.float16, 64, TypeError, "dtype"),
    (torch.float16, 300, TypeError, "dtype"),
])
def test_route_table_refuses(dtype, hd, exc, match):
    with pytest.raises(exc, match=match):
        tfa.route(dtype, hd)


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_wgmma",
                                "flash_attention_mma", "flash_attention_wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrappers_refuse_cpu_tensors(fn, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv_np(8, 1, 16, 2, 2, 64))
    counts = {f: getattr(tfa, f).launches for f in
              ("flash_attention", "flash_attention_wgmma", "flash_attention_mma",
               "flash_attention_wide")}
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tfa, fn)(q, k, v)
    assert counts == {f: getattr(tfa, f).launches for f in counts}


def test_tma_strides_of_fused_projection_views():
    """q/k/v as views of one [B, S, (H + 2 KV) hd] projection: TMA takes
    their strides as they are; a dim of size 1 gets its packed stride."""
    B, S, H, KV, hd = 2, 130, 4, 1, 64
    qkv = torch.zeros((B, S, (H + 2 * KV) * hd), dtype=torch.bfloat16)
    q = qkv[..., :H * hd].reshape(B, S, H, hd)
    k = qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd)
    row = (H + 2 * KV) * hd
    assert tfa.tma_strides(q) == (S * row, row, hd)
    assert tfa.tma_strides(k) == (S * row, row, hd)
    one = torch.zeros((1, 8, 1, hd), dtype=torch.bfloat16)
    assert tfa.tma_strides(one.as_strided(one.shape, (3, hd, 5, 1))) == (8 * hd, hd, hd)


@pytest.mark.parametrize("bad", ["stride", "base"])
def test_tma_strides_refuse_what_tma_cannot_read(bad):
    if bad == "stride":  # heads 68 elements = 136 bytes apart
        t = torch.zeros((1, 8, 4, 68), dtype=torch.bfloat16)[..., :64]
        match = "16-byte multiples"
    else:  # a view starting 2 bytes past an aligned base
        t = torch.zeros((1, 8, 4, 65), dtype=torch.bfloat16)[..., 1:]
        match = "aligned base"
    with pytest.raises(ValueError, match=match):
        tfa.tma_strides(t)


# ---------------------------------------------------------------------------
# Why the f32 route splits its products (numpy, no card needed)
# ---------------------------------------------------------------------------

def _tf32_round(a):
    """a rounded to TF32 (10 mantissa bits), to nearest, ties away from zero,
    as the kernel rounds the high half."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """a as the tensor cores read an f32 operand: the low 13 bits dropped."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tc_matmul(a, b, scheme):
    """a @ b in f32 with the operands as the tensor cores get them: one
    TF32-rounded product ("1xtf32") or the kernel's split (hi rounded, lo =
    a - hi read truncated) summed as lo*hi' + hi*lo' + hi*hi' ("3xtf32")."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    if scheme == "1xtf32":
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_attention_precision_needs_3xtf32():
    """Causal attention at llama3.2-1b's head_dim (64), with S = 512 and the
    inputs chip_smoke.py draws (randn), both products on the tensor cores:
    split in three (3xTF32) the output holds the f32 tolerance (rtol = atol
    = 2e-5) against a float64 oracle; one TF32 product per GEMM does not."""
    S, hd = 512, 64
    q, k, v = (a[0, :, 0] for a in _qkv_np(11, 1, S, 1, 1, hd))
    causal = np.tril(np.ones((S, S), bool))

    def attend(mm):
        s = mm(q, k.T) * np.float32(1 / np.sqrt(hd))
        s = np.where(causal, s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        return mm(p.astype(q.dtype), v) / p.sum(-1, keepdims=True)

    want = attend(lambda a, b: a.astype(np.float64) @ b.astype(np.float64))

    def misses(got):
        return float((np.abs(got - want) - F32_TOL * (1 + np.abs(want))).max())

    assert misses(attend(lambda a, b: _tc_matmul(a, b, "3xtf32"))) <= 0
    assert misses(attend(lambda a, b: _tc_matmul(a, b, "1xtf32"))) > 0


# ---------------------------------------------------------------------------
# The backward kernel's rounding points (no card needed)
# ---------------------------------------------------------------------------

def _bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _bwd_dense(q, k, v, o, do, mm, operand, *, causal=True, softcap=0.0):
    """dq, dk, dv of one batch row [S, H, hd] (k, v [T, KV, hd]) by the
    backward kernel's five products, each through ``mm``; P and dS pass
    through ``operand`` before the products that consume them (dV = P^T dO,
    dK = dS^T Q, dQ = dS K), the way the kernel rounds them."""
    S, H, hd = q.shape
    T, KV = k.shape[:2]
    group, scale = H // KV, 1 / np.sqrt(hd)
    visible = np.tril(np.ones((S, T), bool)) if causal else np.ones((S, T), bool)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for h in range(H):
        kh, vh, qh, doh = k[:, h // group], v[:, h // group], q[:, h], do[:, h]
        s = mm(qh, kh.T) * scale
        th = np.tanh(s / softcap) if softcap > 0 else np.zeros_like(s)
        if softcap > 0:
            s = softcap * th
        s = np.where(visible, s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        delta = (doh * o[:, h]).sum(-1, keepdims=True)
        ds = p * (mm(doh, vh.T) - delta) * (1 - th * th) * scale
        dv[:, h // group] += mm(operand(p).T, doh)
        dk[:, h // group] += mm(operand(ds).T, qh)
        dq[:, h] = mm(operand(ds), kh)
    return dq, dk, dv


BWD_ROUNDING_CASES = [
    ("bfloat16", dict(causal=True)),
    ("bfloat16", dict(causal=True, softcap=20.0)),
    ("float32", dict(causal=True)),
]


@pytest.mark.parametrize("dtype,kw", BWD_ROUNDING_CASES,
                         ids=["bf16-causal", "bf16-softcap20", "f32-causal"])
def test_backward_bf16_operand_rounding_within_tolerance(dtype, kw):
    """At (1, 256, 4, 2, 64), a reduced llama3.2-1b training shape, the
    backward kernel's rounding points hold the kernel tolerances. bf16: the
    products in f32 on the bf16 inputs, P and dS rounded to bf16 before the
    products that consume them (the tensor cores' operands), stay within
    2e-2 of ``flash_attention_bwd_ref``. f32: every product split in three
    (3xTF32) stays within 2e-5 of a float64 oracle; one TF32 product per
    GEMM does not, so the f32 kernel splits them all."""
    q, k, v = (a[0] for a in _qkv_np(5, 1, 256, 4, 2, 64))
    do = np.random.default_rng(6).standard_normal(q.shape, dtype=np.float32)
    if dtype == "bfloat16":
        tq, tk, tv, tdo = (torch.from_numpy(a)[None].bfloat16() for a in (q, k, v, do))
        to = tref(tq, tk, tv, **kw)
        want = flash_attention_bwd_ref(tq, tk, tv, to, tdo, **kw)
        got = _bwd_dense(*(x[0].float().numpy() for x in (tq, tk, tv, to, tdo)),
                         lambda a, b: a @ b, _bf16_round, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(_bf16_round(g), _np(w[0]), rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=name)
        return
    o = _np(tref(*(torch.from_numpy(a)[None] for a in (q, k, v)), **kw)[0])
    want = _bwd_dense(*(a.astype(np.float64) for a in (q, k, v, o, do)),
                      lambda a, b: a @ b, lambda a: a, **kw)

    def misses(scheme):
        got = _bwd_dense(q, k, v, o, do, lambda a, b: _tc_matmul(a, b, scheme),
                         lambda a: a.astype(np.float32), **kw)
        return max(float((np.abs(g - w) - F32_TOL * (1 + np.abs(w))).max())
                   for g, w in zip(got, want))

    assert misses("3xtf32") <= 0
    assert misses("1xtf32") > 0
