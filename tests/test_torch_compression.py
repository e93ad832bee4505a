"""The port's gradient compression (``repro_torch.comms.compression``)
against the reference's (``repro.comms.compression``), on the CPU.

Inputs are made with numpy from a seed. The reference runs eagerly, as the
port does: each op rounds on its own, so q, the scale and the residual
agree bit for bit. Under ``jax.jit`` XLA fuses ``acc - q * scale`` into one
FMA, which rounds once instead of twice (pinned below). The reference's
all-reduce runs under ``jax.vmap(..., axis_name="pod")``, whose ``psum``
sums over the vmapped axis, so no mesh is needed.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_worker as dist_worker  # noqa: E402
from repro.comms import compression as J  # noqa: E402
from repro_torch import comms  # noqa: E402
from repro_torch.comms import compression as T  # noqa: E402

NAMES = ("ef_int8_compress", "ef_int8_decompress", "topk_compress",
         "topk_decompress", "error_feedback_all_reduce")


def _draw(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_exports_the_reference_names():
    import repro.comms as jcomms

    for name in NAMES:
        assert name in comms.__all__ and name in jcomms.__all__
        assert getattr(comms, name) is getattr(T, name)


@pytest.mark.parametrize("shape,scale", [((128,), 1.0), ((3, 37), 3.0), ((4, 5, 6), 1e-3),
                                         ((7,), 1e4)])
def test_ef_int8_compress_bit_equal(shape, scale):
    g, r = _draw(shape, 0, scale), _draw(shape, 1, scale * 1e-2)
    qj, sj, rj = J.ef_int8_compress(jnp.asarray(g), jnp.asarray(r))
    qt, st, rt = T.ef_int8_compress(torch.from_numpy(g), torch.from_numpy(r))
    assert qt.dtype == torch.int8 and st.shape == () and rt.shape == shape
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))
    np.testing.assert_array_equal(_np(rt), np.asarray(rj))
    for dtype in (torch.float32, torch.bfloat16):
        jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        got = T.ef_int8_decompress(qt, st, dtype)
        want = J.ef_int8_decompress(qj, sj, jd)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(_np(got.float()), np.asarray(want, np.float32))


def test_ef_int8_zero_input_keeps_a_positive_scale():
    z = torch.zeros(8)
    q, scale, r = T.ef_int8_compress(z, z)
    assert float(scale) == np.float32(1e-30) / np.float32(127.0)
    assert not q.any() and not r.any()


def test_jitted_reference_fuses_the_residual_into_one_fma():
    """Under jit the reference's residual is ``acc - q * scale`` rounded once
    (an FMA): it differs from the eager (and the port's) residual by at most
    one rounding of the product, and equals the port's q and scale put
    through one rounding."""
    g, r = _draw((3, 37), 0, 3.0), _draw((3, 37), 1, 0.03)
    _, _, rj = jax.jit(J.ef_int8_compress)(jnp.asarray(g), jnp.asarray(r))
    qt, st, rt = T.ef_int8_compress(torch.from_numpy(g), torch.from_numpy(r))
    acc = (g + r).astype(np.float64)
    fma = (acc - _np(qt).astype(np.float64) * np.float64(_np(st))).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(rj), fma)
    ulp = np.spacing(np.abs(_np(qt).astype(np.float32) * _np(st)))
    assert (np.abs(np.asarray(rj) - _np(rt)) <= ulp).all()


def test_int8_roundtrip_error_feedback():
    """``tests/test_comms.py``'s case on the port: 50 steps of error
    feedback keep the long-run sum within 1e-3."""
    g = torch.from_numpy(_draw((128,), 0))
    r = torch.zeros_like(g)
    total_in, total_out = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        q, scale, r = T.ef_int8_compress(g, r)
        total_in = total_in + g
        total_out = total_out + T.ef_int8_decompress(q, scale)
    assert float((total_out + r - total_in).abs().max()) < 1e-3


def test_topk_roundtrip():
    """``tests/test_comms.py``'s case on the port."""
    g = torch.arange(16, dtype=torch.float32) - 8.0
    vals, idx, r2 = T.topk_compress(g, torch.zeros_like(g), k=4)
    dec = T.topk_decompress(vals, idx, (16,))
    assert int(torch.count_nonzero(dec)) == 4
    np.testing.assert_allclose(_np(dec + r2), _np(g), atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 4, 5, 16])
def test_topk_ties_go_to_the_lower_index(k):
    """``arange(16) - 8`` has two 7s and two 6s in magnitude (-7/7 at 1/15,
    -6/6 at 2/14): the reference keeps the lower index of each pair first,
    and so does the port, where ``torch.topk`` promises no order."""
    g = np.arange(16, dtype=np.float32) - 8.0
    r = np.zeros(16, np.float32)
    vj, ij, rj = J.topk_compress(jnp.asarray(g), jnp.asarray(r), k)
    vt, it, rt = T.topk_compress(torch.from_numpy(g), torch.from_numpy(r), k)
    np.testing.assert_array_equal(_np(it), np.asarray(ij))
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))
    np.testing.assert_array_equal(_np(rt), np.asarray(rj))
    if k == 4:
        assert list(_np(it)) == [0, 1, 15, 2]  # 2 kept, 14 dropped


def test_topk_matches_reference_on_a_tensor_with_repeats():
    g = np.round(_draw((6, 10), 3, 2.0)).astype(np.float32)  # many equal magnitudes
    r = np.zeros_like(g)
    for k in (7, 23):
        vj, ij, rj = J.topk_compress(jnp.asarray(g), jnp.asarray(r), k)
        vt, it, rt = T.topk_compress(torch.from_numpy(g), torch.from_numpy(r), k)
        np.testing.assert_array_equal(_np(it), np.asarray(ij))
        np.testing.assert_array_equal(_np(rt), np.asarray(rj))
        dj = J.topk_decompress(vj, ij, g.shape)
        dt = T.topk_decompress(vt, it, g.shape)
        np.testing.assert_array_equal(_np(dt), np.asarray(dj))


def _trees(dp, seed):
    """Stacked [dp, ...] gradient and residual trees; rank r scaled by 8^r,
    so one scale shared across the ranks would quantize the small ones to 0."""
    mag = 8.0 ** np.arange(dp)
    grads = {"w": _draw((dp, 5, 7), seed) * mag[:, None, None],
             "blk": {"b": _draw((dp, 9), seed + 1) * mag[:, None],
                     "s": _draw((dp,), seed + 2)}}
    res = jax.tree.map(lambda a: _draw(a.shape, seed + 3, 1e-2), grads)
    return jax.tree.map(lambda a: a.astype(np.float32), grads), res


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_error_feedback_all_reduce_stacked_vs_vmapped_reference(dp):
    grads, res = _trees(dp, 7)
    ref = jax.vmap(lambda g, r: J.error_feedback_all_reduce(g, r, "pod"), axis_name="pod")
    mj, rj = ref(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res))
    mt, rt = T.error_feedback_all_reduce(_torch_tree(grads), _torch_tree(res))
    assert jax.tree.structure(mt) == jax.tree.structure(mj)
    for got, want in zip(jax.tree.leaves(rt), jax.tree.leaves(rj)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    for got, want, g in zip(jax.tree.leaves(mt), jax.tree.leaves(mj), jax.tree.leaves(grads)):
        assert got.shape == g.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=0)
        assert (_np(got) == _np(got)[:1]).all()  # every rank holds the same mean


def test_error_feedback_all_reduce_scales_each_rank_on_its_own():
    """Each rank's residual equals ``ef_int8_compress`` of its own row; a
    scale shared across ranks would zero the small rank's payload."""
    grads, res = _trees(4, 9)
    _, rt = T.error_feedback_all_reduce(_torch_tree(grads), _torch_tree(res))
    for r in range(4):
        q, scale, want = T.ef_int8_compress(torch.from_numpy(grads["w"][r]),
                                            torch.from_numpy(res["w"][r]))
        np.testing.assert_array_equal(_np(rt["w"][r]), _np(want))
        assert int(q.abs().max()) == 127
    shared = (np.abs(grads["w"] + res["w"]).max() / 127.0)
    assert np.round((grads["w"][0] + res["w"][0]) / shared).max() == 0


def test_error_feedback_all_reduce_mean_within_the_quantization_bound():
    grads, res = _trees(4, 5)
    mt, _ = T.error_feedback_all_reduce(_torch_tree(grads), _torch_tree(res))
    acc = grads["w"] + res["w"]
    scales = np.abs(acc).reshape(4, -1).max(1) / 127.0
    err = np.abs(_np(mt["w"][0]) - acc.mean(0)).max()
    assert 0 < err <= scales.sum() / (2 * 4) * (1 + 1e-5)


def test_error_feedback_all_reduce_only_int8():
    grads, res = _trees(2, 1)
    with pytest.raises(NotImplementedError, match="topk"):
        T.error_feedback_all_reduce(_torch_tree(grads), _torch_tree(res), method="topk")


def test_error_feedback_all_reduce_two_gloo_ranks_equal_stacked(tmp_path):
    """Two gloo ranks, one process each, through ``DistBackend``: each
    rank's mean and residual are the stacked backend's bits. Fails, and
    stops its processes, after 60 s rather than hang."""
    import torch.multiprocessing as mp

    world = 2
    ctx = mp.start_processes(dist_worker.run_compression_rank, nprocs=world, join=False,
                             args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
                             start_method="spawn")
    deadline = time.monotonic() + 60
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks did not finish in 60 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    grads, res = dist_worker.compression_inputs(world)
    mean, new_r = T.error_feedback_all_reduce(_torch_tree(grads), _torch_tree(res))
    for name, m, r in (("w", mean["w"], new_r["w"]), ("b", mean["blk"]["b"], new_r["blk"]["b"])):
        for rank in range(world):
            np.testing.assert_array_equal(np.load(tmp_path / f"mean_{name}.{rank}.npy"),
                                          _np(m[rank]))
            np.testing.assert_array_equal(np.load(tmp_path / f"res_{name}.{rank}.npy"),
                                          _np(r[rank]))
