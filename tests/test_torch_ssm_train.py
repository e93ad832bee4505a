"""The port's training path for the ssm and hybrid families against the JAX
package's, on the CPU: the SSD scan's backward, and ``LM.loss`` with its
gradients for mamba2 and zamba2 at reduced size.

The JAX side differentiates ``repro.models.ssm._ssd_chunked`` (``jax.vjp``),
which is how the reference trains the scan: its Pallas kernel has no VJP.
On the CPU the port's ``ops.ssd_scan_bwd`` runs the kernel's plain version
(``ssd_scan_bwd_ref``, autograd through ``ssd_chunked_ref``); the CUDA
kernel is held against that in tests/test_torch_cuda.py and chip_smoke.py,
and the kernel's decomposition (csrc/ssd_scan_bwd.cu's passes) is held here
in numpy. Inputs are made with numpy from a seed; model weights are
initialised by JAX, given random f32 leaves (dt_bias, A_log, D,
norm_scale), and carried over with ``params_from_jax``. Tolerance 1e-4
(rtol and atol) in f32: the frameworks sum in other orders.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from _torch_cpu import one_torch_thread  # noqa: E402, F401
# the card's check of the SSD backward kernel against its plain version:
# max |got - plain| <= SSD_BWD_TOL * max |plain| for each gradient
from chip_smoke import SSD_BWD_TOL  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models.ssm import _ssd_chunked  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.data.pipeline import _batch_for_step  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_scan_bwd_ref, ssd_scan_ref  # noqa: E402
from repro_torch.launch.train_lm import _tree_like  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402

TOL = 1e-4
F32_LEAVES = ("dt_bias", "A_log", "D", "norm_scale")
GRADS = ("dxh", "ddt", "dA", "dBm", "dCm")


def _inputs(seed, B, S, H, P, N, slow=False):
    """The SSD inputs of tests/test_kernels.py (dt scaled by 0.02 with
    ``slow``: the state then carries across several chunks), and a
    cotangent dy of y, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) * (0.02 if slow else 1.0)
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, N)) * 0.5
    Cm = rng.standard_normal((B, S, N)) * 0.5
    dy = rng.standard_normal((B, S, H, P))
    return [a.astype(np.float32) for a in (xh, dt, A, Bm, Cm)], dy.astype(np.float32)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk,slow", [
    (2, 64, 3, 16, 8, 16, False),   # several chunks
    (1, 12, 2, 16, 8, 16, False),   # S < chunk
    (2, 64, 2, 16, 8, 16, True),    # slow decay: the carry spans chunks
    (1, 96, 2, 32, 16, 32, False),
])
def test_ssd_scan_bwd_ref_matches_jax_vjp(B, S, H, P, N, chunk, slow):
    """y and every gradient of the plain chunked scan against ``jax.vjp``
    of the reference's ``_ssd_chunked``, f32."""
    arrs, dy = _inputs(0, B, S, H, P, N, slow)

    def value_and_vjp(ins, cot):
        y, vjp = jax.vjp(lambda *a: _ssd_chunked(*a, min(chunk, S)), *ins)
        return y, vjp(cot)

    y, want = jax.jit(value_and_vjp)(tuple(map(jnp.asarray, arrs)), jnp.asarray(dy))
    ins = [torch.from_numpy(a) for a in arrs]
    _close(ssd_chunked_ref(*ins, chunk=chunk), y)
    got = ssd_scan_bwd_ref(*ins, torch.from_numpy(dy), chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _close(g, w, msg=name)


@pytest.mark.parametrize("B,S,H,P,N,chunk,slow", [
    (2, 64, 3, 16, 8, 16, False),
    (1, 40, 2, 16, 8, 16, True),    # ragged: S no multiple of the chunk
    (2, 100, 2, 16, 8, 32, True),
    (1, 10, 2, 8, 4, 16, False),    # S < chunk
])
def test_ssd_chunked_ref_matches_recurrence(B, S, H, P, N, chunk, slow):
    """The chunked form against the token-by-token recurrence (the
    forward's plain version), ragged S included."""
    ins = [torch.from_numpy(a) for a in _inputs(1, B, S, H, P, N, slow)[0]]
    _close(ssd_chunked_ref(*ins, chunk=chunk), ssd_scan_ref(*ins))


def test_ssd_chunked_ref_gradient_is_finite_where_decays_underflow():
    """Over a chunk of 128 at dt = softplus(randn) and A = -1 (the
    reference's init, A_log = 0) the prefix sums of dt*A span ~100, where
    exp of the difference above the diagonal overflows in f32. The
    reference masks after the exp and its gradient of dt and A reads
    inf * 0 = nan (a fault of the reference, pinned here); the plain
    backward masks before the exp and stays finite."""
    arrs, dy = _inputs(2, 1, 256, 2, 16, 8)
    arrs[2] = -np.ones_like(arrs[2])
    _, vjp = jax.vjp(lambda *a: _ssd_chunked(*a, 128), *map(jnp.asarray, arrs))
    want = vjp(jnp.asarray(dy))
    assert [bool(np.isnan(np.asarray(w)).any()) for w in want] == [False, True, True,
                                                                   False, False]
    got = ssd_scan_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), chunk=128)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for name, g, w in zip(GRADS, got, want):
        if name in ("dxh", "dBm", "dCm"):
            _close(g, w, msg=name)


# ---------------------------------------------------------------------------
# the CUDA kernel's decomposition, in numpy (csrc/ssd_scan_bwd.cu's passes)
# ---------------------------------------------------------------------------

def _f64_matmul(a, b):
    return a @ b


def _kernel_passes(xh, dt, A, Bm, Cm, dy, Q, G=1, fault=None, mm=_f64_matmul):
    """The backward as the kernel's passes compute it (csrc/ssd_scan_bwd.cu),
    elementwise in float64, every product through ``mm``: the states
    entering each chunk (the forward's passes (a), (b)); each chunk's
    reverse state R and the reverse walk of the carries; per chunk, padded
    to Qp (a multiple of 16), S = C B^T on the 16 x 16 tiles on and below
    the diagonal; per head dy x^T gives W = (dy x^T) o L o dt on those tiles,
    the decay below the diagonal tile a row factor exp(csum_k - csum_r)
    times a column factor exp(csum_r - csum_j) (r the tile's first row) and
    an exp per element on it; (S o L)^T dy over the tiles from the diagonal
    on (row factor exp(csum_e - csum_i), e the tile's last row, after it);
    B carry^T and C h_in^T; r, and dl by its reverse scan, give ddt and dA.
    dB and dC of a group of G heads: Wsum B and Wsum^T C, Wsum = sum_h W in
    head order, plus each head's inter part; the groups summed in order.
    ``fault`` plants an error: "no_carry" drops the adjoint carried in from
    later chunks, "no_h_out" the <carry, h_out> term of the last position's
    r."""
    x, d, a, b, c, g = (np.asarray(v, np.float64) for v in (xh, dt, A, Bm, Cm, dy))
    Bz, S, H, P = x.shape
    N, nc, Qp = b.shape[-1], -(-S // Q), -(-Q // 16) * 16
    assert H % G == 0
    tile = np.arange(Qp) // 16
    below = tile[:, None] > tile[None, :]     # tiles below the diagonal tile
    on = tile[:, None] == tile[None, :]
    causal = np.arange(Qp)[:, None] >= np.arange(Qp)[None, :]
    dx, ddt, dA = np.zeros_like(x), np.zeros_like(d), np.zeros(H)
    dB, dC = np.zeros_like(b), np.zeros_like(c)

    def pad(v):  # a chunk's rows, zero-padded to Qp
        return np.concatenate([v, np.zeros((Qp - len(v),) + v.shape[1:])])

    for bi in range(Bz):
        cs, h_in, rev = {}, {}, {}
        for h in range(H):  # the forward's states, R and the carries
            state = np.zeros((P, N))
            for ci in range(nc):
                sl = slice(ci * Q, min(S, (ci + 1) * Q))
                csum = np.cumsum(pad(d[bi, sl, h]) * a[h])
                cs[h, ci], h_in[h, ci] = csum, state
                w = pad(d[bi, sl, h]) * np.exp(csum[-1] - csum)
                state = np.exp(csum[-1]) * state + mm((pad(x[bi, sl, h]) * w[:, None]).T,
                                                      pad(b[bi, sl]))
                rev[h, ci] = mm((pad(g[bi, sl, h]) * np.exp(csum)[:, None]).T, pad(c[bi, sl]))
        carry = {}
        for h in range(H):
            s = np.zeros((P, N))
            for ci in reversed(range(nc)):
                carry[h, ci] = np.zeros((P, N)) if fault == "no_carry" else s
                s = rev[h, ci] + np.exp(cs[h, ci][-1]) * s
        for ci in range(nc):
            sl = slice(ci * Q, min(S, (ci + 1) * Q))
            nv = sl.stop - sl.start
            Bq, Cq = pad(b[bi, sl]), pad(c[bi, sl])
            Sc = np.where(below | on, mm(Cq, Bq.T), 0.0)  # the causal tiles
            for h0 in range(0, H, G):
                Wsum, dB_g, dC_g = np.zeros((Qp, Qp)), np.zeros((Qp, N)), np.zeros((Qp, N))
                for h in range(h0, h0 + G):
                    csum, X, Dy = cs[h, ci], pad(x[bi, sl, h]), pad(g[bi, sl, h])
                    dq = pad(d[bi, sl, h])
                    first, last = csum[16 * tile], csum[16 * tile + 15]
                    diag = np.exp(np.minimum(csum[:, None] - csum[None, :], 0.0))
                    Lw = np.where(below, np.exp(csum - first)[:, None]
                                  * np.exp(first[:, None] - csum[None, :]),
                                  np.where(on & causal, diag, 0.0)) * dq[None, :]
                    W = mm(Dy, X.T) * Lw
                    Sm = W * Sc
                    # (S o L)^T: A2t[i][k] = S[k][i] L[k][i], k in the tiles from i's on
                    A2t = np.where(below.T, Sc.T * np.exp(csum[None, :] - last[:, None])
                                   * np.exp(last - csum)[:, None],
                                   np.where(on & causal.T, Sc.T * diag.T, 0.0))
                    e = np.exp(csum[-1] - csum)
                    dxe = mm(Bq, carry[h, ci].T)
                    U = mm(Cq, h_in[h, ci].T)
                    dxt = mm(A2t, Dy) + e[:, None] * dxe
                    r = (Sm.sum(1) - Sm.sum(0) + np.exp(csum) * (Dy * U).sum(1)
                         - dq * e * (X * dxe).sum(1))
                    if ci < nc - 1 and fault != "no_h_out":
                        r[nv - 1] += (carry[h, ci] * h_in[h, ci + 1]).sum()
                    dl = np.cumsum(r[::-1])[::-1]  # the reverse scan
                    dx[bi, sl, h] = (dq[:, None] * dxt)[:nv]
                    ddt[bi, sl, h] = ((X * dxt).sum(1) + a[h] * dl)[:nv]
                    dA[h] += (dq * dl).sum()
                    Wsum += W
                    dC_g += np.exp(csum)[:, None] * mm(Dy, h_in[h, ci])
                    dB_g += (dq * e)[:, None] * mm(X, carry[h, ci])
                dC[bi, sl] += (mm(Wsum, Bq) + dC_g)[:nv]
                dB[bi, sl] += (mm(Wsum.T, Cq) + dB_g)[:nv]
    return dx, ddt, dA, dB, dC


@pytest.mark.parametrize("B,S,H,P,N,chunk,slow", [
    (2, 64, 3, 16, 8, 16, False),
    (1, 96, 2, 16, 8, 16, True),
    (2, 70, 2, 16, 8, 20, True),   # ragged, chunk no multiple of 16
    (1, 10, 2, 8, 4, 16, False),   # one chunk
])
def test_ssd_backward_kernel_passes_match_plain(B, S, H, P, N, chunk, slow):
    arrs, dy = _inputs(3, B, S, H, P, N, slow)
    want = ssd_scan_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), chunk=chunk)
    for name, g, w in zip(GRADS, _kernel_passes(*arrs, dy, chunk), want):
        _close(g, w, msg=name)


@pytest.mark.parametrize("H,G", [(6, 1), (6, 2), (6, 3), (3, 3)])
def test_ssd_backward_kernel_passes_sum_groups_of_heads(H, G):
    """dB and dC summed over each group of G heads (Wsum once a group, then
    each head's inter part) and then over the groups: the plain backward's
    at every G, with an H that 2 does not divide among them; chunks of 48
    (three 16-row tiles) and a ragged last chunk, slow decay."""
    arrs, dy = _inputs(8, 1, 100, H, 16, 8, slow=True)
    want = ssd_scan_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), chunk=48)
    for name, g, w in zip(GRADS, _kernel_passes(*arrs, dy, 48, G=G), want):
        _close(g, w, msg=name)


def test_ssd_bwd_precision_needs_3xtf32():
    """Every product of the kernel's passes on the tensor cores, emulated
    (tests/test_torch_kernels.py's TF32 rounding): as one TF32 product each
    the gradients miss the card's check, max |got - plain| <= SSD_BWD_TOL x
    max |plain| (tests/test_torch_cuda.py, chip_smoke.py), every one of
    them; split in three (3xTF32, as the kernel runs them) they hold it.
    Slow decay, so that the carries cross chunks."""
    from test_torch_kernels import _tc_matmul

    arrs, dy = _inputs(9, 1, 256, 2, 32, 16, slow=True)
    want = ssd_scan_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), chunk=64)

    def misses(scheme):
        got = _kernel_passes(*arrs, dy, 64,
                             mm=lambda a, b: _tc_matmul(a, b, scheme).astype(np.float64))
        return [float(np.abs(g - w.numpy()).max()) > SSD_BWD_TOL * float(w.abs().max())
                for g, w in zip(got, want)]

    assert misses("3xtf32") == [False] * 5
    assert misses("1xtf32") == [True] * 5


@pytest.mark.parametrize("fault", ["no_carry", "no_h_out"])
def test_ssd_backward_slow_decay_inputs_see_the_carry(fault):
    """On slow-decay inputs the adjoint carried across chunks matters: the
    passes with either part of it dropped miss the plain backward by more
    than 100 times the tolerance (the checks on the card use such inputs)."""
    arrs, dy = _inputs(4, 1, 128, 2, 16, 8, slow=True)
    want = ssd_scan_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), chunk=16)
    got = _kernel_passes(*arrs, dy, 16, fault=fault)
    miss = max(float(np.abs(g - w.numpy()).max()) for g, w in zip(got, want))
    assert miss > 100 * TOL


# ---------------------------------------------------------------------------
# the card's wrapper, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,N,chunk", [(128, 256, 256), (48, 96, 128), (20, 5, 300),
                                       (64, 128, 128)])
def test_ssd_sliced_backward_is_exact_on_cpu(P, N, chunk):
    """The card's backward wrapper at sizes the kernel is not built for:
    each launch (here the plain backward, checking that it gets built
    sizes) sees a zero-padded slice of x and of the state; the assembled
    gradients are the backward's at the asked sizes, within the file's
    tolerance (ddt and dA sum the slices' parts, ddt reaching ~240 here)."""
    arrs, dy = _inputs(5, 2, 40, 3, P, N)
    ins = [torch.from_numpy(a) for a in arrs] + [torch.from_numpy(dy)]
    launches = []

    def launch(x, d, a, b, c, g, run_chunk):
        assert x.shape[-1] in tssd.HEAD_DIMS and b.shape[-1] in tssd.STATE_SIZES
        assert run_chunk <= tssd.MAX_CHUNK and x.is_contiguous() and b.is_contiguous()
        launches.append(1)
        return tops.ssd_scan_bwd(x, d, a, b, c, g, chunk=run_chunk)

    got = tssd._sliced_bwd(*ins, chunk, launch)
    want = tops.ssd_scan_bwd(*ins, chunk=chunk)
    p_cuts, n_cuts, _ = tssd.slice_plan(P, N, chunk)
    assert len(launches) == len(p_cuts) * len(n_cuts)
    for name, g, w in zip(GRADS, got, want):
        _close(g, w, msg=name)


def test_ssd_scan_bwd_checks_shapes_and_device():
    arrs, dy = _inputs(6, 1, 8, 2, 16, 8)
    ins = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="must be shaped as xh"):
        tops.ssd_scan_bwd(*ins, torch.from_numpy(dy)[:, :4])
    with pytest.raises(ValueError, match="does not fit"):
        tops.ssd_scan_bwd(ins[0], ins[1][..., :1], *ins[2:], torch.from_numpy(dy))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_scan_bwd(*ins, torch.from_numpy(dy))
    tssd.ssd_scan_bwd.launches = 0
    tops.ssd_scan_bwd(*ins, torch.from_numpy(dy))
    assert tssd.ssd_scan_bwd.launches == 0  # CPU tensors never launch


# ---------------------------------------------------------------------------
# LM.loss and its gradients
# ---------------------------------------------------------------------------

def _with_random_f32_leaves(tree, seed):
    """The zeros/ones inits of the SSM's f32 leaves replaced by random
    values (A_log and dt_bias small, so the decay stays in range)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if not isinstance(t, dict):
            return t
        out = {}
        for k, v in t.items():
            if k in F32_LEAVES:
                scale = 0.3 if k in ("A_log", "dt_bias") else 1.0
                base = 1.0 if k in ("D", "norm_scale") else 0.0
                v = (base + scale * rng.standard_normal(v.shape)).astype(np.float32)
            out[k] = walk(v)
        return out

    return walk(tree)


def _counting(fn, calls, key):
    def wrapped(*args, **kw):
        calls[key] += 1
        return fn(*args, **kw)
    return wrapped


# arch, reduced-config overrides, remat: mamba2, and zamba2 without a tail
# (2 groups of 2) and with one like zamba2-7b's (2 groups of 3, then 1)
LM_CASES = {
    "ssm": ("mamba2-370m", {}, False),
    "hybrid": ("zamba2-7b", {}, False),
    "hybrid_tail_remat": ("zamba2-7b", dict(num_layers=7, hybrid_attn_period=3), True),
}


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_loss_and_grads_match_jax(name):
    """``LM.loss`` and every gradient leaf (the SSD scan through its
    training autograd function, the hybrid's shared block called once a
    group and its gradients summed over the calls) against
    ``jax.value_and_grad`` of the reference's ``LM.loss``, f32."""
    arch, over, remat = LM_CASES[name]
    jcfg = jget_config(arch).reduced(dtype="float32", **over)
    tcfg = tget_config(arch).reduced(dtype="float32", **over)
    npp = _with_random_f32_leaves(jax.tree.map(np.asarray, jax.jit(JLM(jcfg).init)(
        jax.random.PRNGKey(0))), seed=7)
    jparams = jax.tree.map(jnp.asarray, npp)
    batch = _batch_for_step(5, 0, 2, 32, jcfg.vocab_size)  # 2 chunks of 16
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(JLM(jcfg).loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(npp, device="cpu", dtype=torch.float32)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    calls = {"ssd_scan_bwd": 0, "attention_bwd": 0}
    lm = TLM(tcfg, device="cpu", remat=remat,
             ssd_scan_bwd=_counting(tops.ssd_scan_bwd, calls, "ssd_scan_bwd"),
             attention_bwd=_counting(tops.flash_attention_bwd, calls, "attention_bwd"))
    loss, metrics = lm.loss(params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    groups = tcfg.num_layers // tcfg.hybrid_attn_period if tcfg.family == "hybrid" else 0
    assert calls == {"ssd_scan_bwd": tcfg.num_layers, "attention_bwd": groups}
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(metrics["xent"].detach()) == pytest.approx(float(jmetrics["xent"]), rel=1e-5)
    assert float(metrics["moe_aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [tuple(k.key for k in path) for path, _ in jleaves] == \
        [path for path, _ in named_leaves(params)]
    for (path, jg), g in zip(jleaves, grads):
        _close(g, jg, msg=str(path))


@pytest.mark.parametrize("arch,over", [("mamba2-370m", {}),
                                       ("zamba2-7b", dict(num_layers=7, hybrid_attn_period=3))])
def test_remat_gives_equal_grads_and_counts_the_recompute(arch, over):
    """Remat per block recomputes each block's forward in the backward: the
    same loss and gradients, bit for bit, with the scan run twice a Mamba
    block and its backward once. Serving (no autograd) never takes the
    backward and runs the scan once a block."""
    cfg = tget_config(arch).reduced(dtype="float32", **over)
    params = TLM(cfg, device="cpu").init(3, param_dtype=torch.float32)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch_for_step(2, 0, 2, 32, cfg.vocab_size).items()}
    out = {}
    for remat in (False, True):
        calls = {"scan": 0, "bwd": 0}
        lm = TLM(cfg, device="cpu", remat=remat,
                 ssd_scan=_counting(tops.ssd_scan, calls, "scan"),
                 ssd_scan_bwd=_counting(tops.ssd_scan_bwd, calls, "bwd"))
        leaves = [t.detach().clone().requires_grad_(True) for _, t in named_leaves(params)]
        tree = _tree_like(params, iter(leaves))
        loss, _ = lm.loss(tree, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
        assert calls == {"scan": cfg.num_layers * (2 if remat else 1), "bwd": cfg.num_layers}
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    calls = {"scan": 0, "bwd": 0}
    lm = TLM(cfg, device="cpu", ssd_scan=_counting(tops.ssd_scan, calls, "scan"),
             ssd_scan_bwd=_counting(tops.ssd_scan_bwd, calls, "bwd"))
    with torch.inference_mode():
        lm.forward_logits(params, batch["tokens"])
    assert calls == {"scan": cfg.num_layers, "bwd": 0}

