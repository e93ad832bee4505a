"""The flash backward's route table and its wgmma route, on the CPU.

``BWD_ROUTES`` sends bf16 at head_dim 64 and 128 to the TMA and wgmma
kernel (``csrc/flash_attention_bwd_wgmma.cu``) and every other (dtype,
head_dim) to the mma.sync kernel (``csrc/flash_attention_bwd.cu``). Neither
kernel runs here: these tests hold the table, the wrappers' refusals and the
routing, the operator's CPU path (the plain backward) against the JAX
package's blockwise custom VJP (``_flash_bwd_vjp``) at the new route's
shapes, the profiler's names for the new passes, and the source's own rules.
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: 2e-5 (rtol = atol) in f32 and 2e-2 in bf16, the kernel tests'
(tests/test_torch_kernels.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import blockwise_attention  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref  # noqa: E402
from repro_torch.launch import trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WGMMA_SRC = ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_routes_cover_every_head_dim(dtype):
    """Every head_dim from 1 to 128 has a route; wgmma exactly at bf16 64
    and 128, mma everywhere else."""
    routes = {hd: tfa.bwd_route(dtype, hd) for hd in range(1, tfa.BWD_MAX_HEAD_DIM + 1)}
    assert tfa.BWD_MAX_HEAD_DIM == 128
    wgmma = {hd for hd, r in routes.items() if r == "wgmma"}
    assert wgmma == ({64, 128} if dtype == torch.bfloat16 else set())
    assert set(routes.values()) <= {"wgmma", "mma"}
    assert {hd for d, hd in tfa.BWD_ROUTES if d == dtype} == set(range(1, 129))


@pytest.mark.parametrize("hd", [0, 129, 256])
def test_bwd_route_refuses_head_dims_outside(hd):
    for dtype in (torch.float32, torch.bfloat16):
        assert (dtype, hd) not in tfa.BWD_ROUTES
        with pytest.raises(ValueError, match="head_dim 1..128"):
            tfa.bwd_route(dtype, hd)


def test_bwd_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        tfa.bwd_route(torch.float16, 64)


def _bf16(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _refused(case):
    """q, k, v, o, dout for a case the wgmma wrapper must refuse."""
    if case == "cpu":
        q = _bf16((1, 16, 4, 64))
        return q, _bf16((1, 16, 2, 64)), _bf16((1, 16, 2, 64)), q, q
    if case == "f32":
        q = _bf16((1, 16, 4, 64)).float()
        return q, q[:, :, :2], q[:, :, :2], q, q
    if case == "hd96":
        q = _bf16((1, 16, 4, 96))
        return q, q[:, :, :2], q[:, :, :2], q, q
    if case == "stride":  # rows 65 bf16 apart: 130 bytes, no 16-byte multiple
        q = _bf16((1, 16, 4, 65))[..., :64]
        k = _bf16((1, 16, 2, 64))
        return q, k, k, q, q
    if case == "base":  # a view starting 2 bytes past a 16-byte boundary
        q = _bf16((1, 16, 4, 65))[..., 1:]
        k = _bf16((1, 16, 2, 64))
        return q, k, k, q, q
    raise AssertionError(case)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"),
    ("f32", "bf16 at head_dim 64 or 128"),
    ("hd96", "bf16 at head_dim 64 or 128"),
    ("stride", "strides of 16-byte multiples"),
    ("base", "16-byte aligned base"),
])
def test_wgmma_backward_refuses_what_it_does_not_take(case, match):
    """The wgmma wrapper raises, and counts no launch, on a CPU tensor, on
    f32, on another head_dim and on a view TMA cannot read."""
    before = (tfa.flash_attention_bwd_wgmma.launches, tfa.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_bwd_wgmma(*_refused(case))
    assert (tfa.flash_attention_bwd_wgmma.launches, tfa.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 96, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.float32, 64, "mma"), (torch.float32, 128, "mma"),
])
def test_backward_routes_to_the_table_and_totals_launches(monkeypatch, dtype, hd, route):
    """``flash_attention_bwd`` calls the wrapper ``BWD_ROUTES`` names, with
    its keywords, and adds that wrapper's launches to its own total."""
    calls = []

    def fake(name):
        def fn(q, k, v, o, dout, **kw):
            calls.append((name, kw))
            fn.launches += 1
            return q, k, v
        fn.launches = 0
        return fn

    fakes = {name: fake(name) for name in ("wgmma", "mma")}
    monkeypatch.setattr(tfa, "_BWD_ROUTE_FNS", fakes)
    monkeypatch.setattr(tfa.flash_attention_bwd, "launches", 7)
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    tfa.flash_attention_bwd(q, q, q, q, q, causal=False, window=3, softcap=2.0)
    assert calls == [(route, dict(causal=False, window=3, softcap=2.0))]
    assert tfa.flash_attention_bwd.launches == 8


# the new route's shapes at a small size, f32 (the algorithm) and one bf16
# case: B, S, T, H, KV, hd, dtype, mask. GQA groups of 4 (8 on 2) and 7 (7
# on 1, llava's), T != S, S not a multiple of the kernel's 128-row tiles
SMALL_CASES = [
    (1, 128, 128, 8, 2, 64, "float32", dict(causal=True)),
    (1, 128, 128, 7, 1, 128, "float32", dict(causal=True)),
    (1, 128, 128, 8, 2, 64, "float32", dict(causal=True, window=32)),
    (1, 128, 128, 7, 1, 128, "float32", dict(causal=True, window=48)),
    (1, 128, 128, 8, 2, 128, "float32", dict(causal=True, softcap=20.0)),
    (1, 64, 160, 8, 2, 64, "float32", dict(causal=False)),
    (2, 96, 96, 7, 1, 64, "float32", dict(causal=False)),
    (1, 130, 130, 8, 2, 128, "float32", dict(causal=True, window=50, softcap=20.0)),
    (1, 128, 128, 8, 2, 64, "bfloat16", dict(causal=True)),
]


def _case_id(case):
    B, S, T, H, KV, hd, dt, kw = case
    return (f"{B}x{S}x{T}x{H}x{KV}x{hd}-{dt}-"
            + "-".join(f"{k}{v}" for k, v in kw.items()))


def _inputs(seed, B, S, T, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd), (B, S, H, hd)))


@pytest.mark.parametrize("case", SMALL_CASES, ids=_case_id)
def test_operator_cpu_path_matches_flash_bwd_vjp(case):
    """The ``torch.library`` operator on CPU tensors is the plain backward,
    launches no kernel, and matches the JAX package's blockwise custom VJP
    at the wgmma route's shapes."""
    B, S, T, H, KV, hd, dt, kw = case
    q, k, v, do = _inputs(3, B, S, T, H, KV, hd)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(getattr(torch, dt)) for x in (q, k, v, do))
    o = flash_attention_ref(tq, tk, tv, **kw)
    before = tfa.flash_attention_bwd.launches
    got = tops.flash_attention_bwd(tq, tk, tv, o, tdo, **kw)
    assert tfa.flash_attention_bwd.launches == before
    for g, w in zip(got, flash_attention_bwd_ref(tq, tk, tv, o, tdo, **kw)):
        assert g.dtype == tq.dtype and g.is_contiguous() and torch.equal(g, w)

    jdt = jnp.dtype(dt)
    fn = lambda a, b, c: blockwise_attention(a, b, c, block_q=64, block_kv=64, **kw)  # noqa: E731
    want = jax.jit(lambda a, b, c, d: jax.vjp(fn, a, b, c)[1](d))(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=TOL[dt], atol=TOL[dt], err_msg=name)


@pytest.mark.parametrize("symbol", [
    # each pass of the wgmma backward, as the profiler and ptxas name it
    "void (anonymous namespace)::flash_bwd_wgmma_lse_kernel<64>(CUtensorMap_st, "
    "CUtensorMap_st, (anonymous namespace)::Params)",
    "void (anonymous namespace)::flash_bwd_wgmma_dkdv_kernel<128>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
    "_ZN61_GLOBAL__N__08759a66_28_flash_attention_bwd_wgmma_cu_7237300a25flash_bwd_wgmma_dq_"
    "kernelILi64EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE",
])
def test_trace_kind_of_wgmma_backward_passes(symbol):
    assert trace.kind_of(symbol) == "flash_attention_bwd"


def test_build_sources_hold_the_wgmma_backward():
    """Every CUDA source is built, the wgmma backward among them, and it
    stands alone: the build hashes the one file, so it includes no header
    of the repo's own."""
    csrc = {p.stem for p in WGMMA_SRC.parent.glob("*.cu")}
    assert set(build.SOURCES) == csrc
    assert {"flash_attention_bwd", "flash_attention_bwd_wgmma"} <= set(build.SOURCES)
    assert not re.search(r'#include\s*"', WGMMA_SRC.read_text())
    assert not list(WGMMA_SRC.parent.glob("*.cuh")) + list(WGMMA_SRC.parent.glob("*.h"))


def test_wgmma_backward_source_keeps_its_rules():
    """Every product is a wgmma on tiles that TMA loads through mbarriers;
    no atomics and no mma.sync; the note names what the kernel replaces,
    its bound and its design; each pass is named as the profiler expects."""
    src = WGMMA_SRC.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "wgmma.mma_async" in code and "cp.async.bulk.tensor" in code
    assert "mbarrier.try_wait" in code and "setmaxnreg" in code
    assert not re.search(r"atomic|red\.global|mma\.sync|ldmatrix", code)
    note = src.split("#include")[0]
    for phrase in ("Replaces", "_flash_bwd_vjp", "Bound", "Design"):
        assert phrase in note
    for name in ("lse", "dkdv", "dq"):
        assert f"flash_bwd_wgmma_{name}_kernel" in code
    assert "repro_flash_attention_bwd_wgmma" in code
