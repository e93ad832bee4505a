"""The port's SSD scan and ssm-family LM (mamba2) against the JAX package's,
on the CPU: in f32, and once in bf16 as the model is served.

On the CPU the port's ``ops.ssd_scan`` runs the kernel's plain version (the
token-by-token recurrence); it is held against the Pallas kernel in
interpret mode and the jnp oracle at tests/test_kernels.py's shapes and
tolerance (1e-4). The model's weights are initialised by JAX, given random
f32 leaves (dt_bias, A_log, D, norm_scale) so that those paths are
exercised, and carried over with ``params_from_jax``; inputs are made with
numpy. Tolerance 1e-4 (rtol and atol): the frameworks sum in other orders,
and the reference model scans in chunks (``_ssd_chunked``) where the port's
CPU path steps token by token. The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import ssd_scan_ref as jref  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch.serve import make_prompts, serve  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-4
ARCH = "mamba2-370m"
F32_LEAVES = ("dt_bias", "A_log", "D", "norm_scale")


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _ssd_inputs(seed, B, S, H, P, N):
    """The inputs of tests/test_kernels.py's SSD tests, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return xh, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 96, 2, 16, 8, 32),
    (1, 64, 1, 64, 32, 64),  # single chunk
    (1, 40, 2, 16, 8, 16),   # ragged: S is no multiple of the chunk
])
def test_ssd_scan_matches_pallas_and_oracle(B, S, H, P, N, chunk):
    arrs = _ssd_inputs(0, B, S, H, P, N)
    tssd.ssd_scan.launches = 0
    got = tops.ssd_scan(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    assert tssd.ssd_scan.launches == 0  # CPU tensors never launch
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    jarrs = [jnp.asarray(a) for a in arrs]
    for want in (jops.ssd_scan(*jarrs, chunk=chunk), jref(*jarrs)):
        _close(got, want)


@pytest.mark.parametrize("S", [1, 37])
def test_ssd_scan_final_state_matches_numpy_recurrence(S):
    xh, dt, A, Bm, Cm = _ssd_inputs(1, 2, S, 3, 16, 8)
    h = np.zeros((2, 3, 16, 8), np.float64)
    ys = []
    for t in range(S):
        decay = np.exp(dt[:, t] * A[None, :])
        h = h * decay[..., None, None] + np.einsum(
            "bn,bhp->bhpn", Bm[:, t], xh[:, t] * dt[:, t, :, None])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    y, state = tops.ssd_scan(*(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)),
                             chunk=16, return_state=True)
    assert state.dtype == torch.float32 and state.shape == (2, 3, 16, 8)
    _close(state, h)
    _close(y, np.stack(ys, 1))


def test_ssd_scan_inputs_exercise_the_carry():
    """At these inputs' decay rates a scan that restarts every chunk from a
    zero state misses by far more than the tolerance, so the scan checks
    (here and on the card) hold the state carried across chunks."""
    B, S, H, P, N, chunk = 2, 128, 4, 32, 16, 32
    xh, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(0, B, S, H, P, N))
    whole = tops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    pieces = torch.cat([tops.ssd_scan(xh[:, t:t + chunk], dt[:, t:t + chunk], A,
                                      Bm[:, t:t + chunk], Cm[:, t:t + chunk], chunk=chunk)
                        for t in range(0, S, chunk)], 1)
    assert float((pieces - whole).abs().max()) > 100 * TOL


# ---------------------------------------------------------------------------
# the CUDA kernel's decomposition, in numpy: chunk states -> state passing ->
# chunk outputs (csrc/ssd_scan.cu's three passes), with its TF32 products
# ---------------------------------------------------------------------------

def _slow_ssd_inputs(seed, B, S, H, P, N):
    """_ssd_inputs with dt scaled by 0.02: a chunk of 128 then decays the
    state by ~e^-2, so the carry spans several chunks."""
    xh, dt, A, Bm, Cm = _ssd_inputs(seed, B, S, H, P, N)
    return xh, (0.02 * dt).astype(np.float32), A, Bm, Cm


def _recurrence64(xh, dt, A, Bm, Cm):
    """The token-by-token recurrence in float64: y [B,S,H,P], state [B,H,P,N]."""
    x, d, a, b, c = (np.asarray(v, np.float64) for v in (xh, dt, A, Bm, Cm))
    B, S, H, P = x.shape
    h = np.zeros((B, H, P, b.shape[-1]))
    ys = np.empty_like(x)
    for t in range(S):
        h = h * np.exp(d[:, t] * a)[..., None, None] + np.einsum(
            "bn,bhp->bhpn", b[:, t], x[:, t] * d[:, t, :, None])
        ys[:, t] = np.einsum("bhpn,bn->bhp", h, c[:, t])
    return ys, h


def _tf32_round(a):
    """a rounded to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """a as the tensor cores read an f32 operand: the low 13 bits dropped."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _product(scheme):
    """a @ b with f32 accumulation, the operands as the scheme feeds them:
    "f32" as they are, "1xtf32" rounded to TF32, "3xtf32" split as the
    kernel splits them (hi rounded, lo = a - hi read truncated) and summed
    as lo*hi' + hi*lo' + hi*hi'."""
    def mm(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        if scheme == "f32":
            return a @ b
        ah, bh = _tf32_round(a), _tf32_round(b)
        if scheme == "1xtf32":
            return ah @ bh
        al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    return mm


def _three_pass(xh, dt, A, Bm, Cm, Q, mm, fault=None):
    """The kernel's decomposition of the scan (S a multiple of Q). ``fault``
    plants an error in the state passing: "decay_twice" applies each chunk's
    exp(total) twice, "no_carry" keeps only the previous chunk's own state
    (the state from two chunks back and earlier is left out)."""
    B, S, H, P = xh.shape
    N, nc = Bm.shape[-1], S // Q
    y = np.empty((B, S, H, P), np.float32)
    final = np.empty((B, H, P, N), np.float32)
    for b in range(B):
        for h in range(H):
            parts = []
            for c in range(nc):  # (a) each chunk's own state and total decay
                sl = slice(c * Q, (c + 1) * Q)
                d = dt[b, sl, h].astype(np.float64)
                csum = np.cumsum(d * A[h])
                w = (d * np.exp(csum[-1] - csum)).astype(np.float32)
                dstate = mm((xh[b, sl, h] * w[:, None]).T, Bm[b, sl])
                parts.append((sl, d, csum, np.float32(csum[-1]), dstate))
            state, state_in = np.zeros((P, N), np.float32), []
            for _, _, _, total, dstate in parts:  # (b) state passing
                state_in.append(state)
                decay = np.exp(total) ** (2 if fault == "decay_twice" else 1)
                state = dstate if fault == "no_carry" else decay * state + dstate
            final[b, h] = state
            for (sl, d, csum, _, _), s_in in zip(parts, state_in):  # (c) outputs
                L = np.tril(np.exp(csum[:, None] - csum[None, :]))
                scores = mm(Cm[b, sl], Bm[b, sl].T)
                intra = mm((scores * L * d[None, :]).astype(np.float32), xh[b, sl, h])
                inter = np.exp(csum)[:, None] * mm(Cm[b, sl], s_in.T)
                y[b, sl, h] = intra + inter
    return y, final


def _misses(got, want, tol=TOL):
    """How far got is outside allclose(rtol = atol = tol) of want (<= 0: inside)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) - tol * (1 + np.abs(want))).max())


def test_ssd_slow_decay_inputs_see_the_state_passing():
    """On slow-decay inputs the state carries across several chunks, so a
    state passing with a wrong decay misses the recurrence by more than 100
    times the tolerance, where the kernel's decomposition holds it (the
    fast-decay inputs forget a chunk's carry before the next ends)."""
    B, S, H, P, N, Q = 1, 1024, 2, 16, 64, 128
    arrs = _slow_ssd_inputs(3, B, S, H, P, N)
    want_y, want_state = _recurrence64(*arrs)
    y, state = _three_pass(*arrs, Q, _product("f32"))
    assert _misses(y, want_y) <= 0 and _misses(state, want_state) <= 0
    for fault in ("decay_twice", "no_carry"):
        y, _ = _three_pass(*arrs, Q, _product("f32"), fault=fault)
        assert float(np.abs(y - want_y).max()) > 100 * TOL, fault
    # the fast-decay inputs cannot tell the carry from no carry
    fast = _ssd_inputs(3, B, S, H, P, N)
    y, _ = _three_pass(*fast, Q, _product("f32"), fault="no_carry")
    assert _misses(y, _recurrence64(*fast)[0]) <= 0


def test_ssd_three_pass_precision_needs_3xtf32():
    """The kernel's three passes with its tensor-core products against the
    float64 recurrence, at a slice-like shape (Q = N = 128, P = 64) on the
    inputs chip_smoke.py draws: split into three TF32 products (3xTF32) they
    hold rtol = atol = 1e-4, plain TF32 does not."""
    arrs = _ssd_inputs(4, 1, 1024, 4, 64, 128)
    want_y, want_state = _recurrence64(*arrs)
    y3, s3 = _three_pass(*arrs, 128, _product("3xtf32"))
    assert _misses(y3, want_y) <= 0 and _misses(s3, want_state) <= 0
    y1, _ = _three_pass(*arrs, 128, _product("1xtf32"))
    assert _misses(y1, want_y) > 0


def test_ssd_scan_checks_shapes_and_device():
    xh, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(2, 1, 8, 2, 16, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tops.ssd_scan(xh, dt[:, :, :1], A, Bm, Cm)
    with pytest.raises(ValueError, match="want xh"):
        tops.ssd_scan(xh, dt, A, Bm, Cm[..., :4])
    with pytest.raises(ValueError, match="no ssd_scan for device"):
        tops.ssd_scan(*(t.to("meta") for t in (xh, dt, A, Bm, Cm)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_scan(xh, dt, A, Bm, Cm)


# ---------------------------------------------------------------------------
# the block and its decode step
# ---------------------------------------------------------------------------

D_MODEL, HEAD_DIM, STATE, CHUNK, CONV = 64, 16, 8, 16, 4


@pytest.fixture(scope="module")
def block_params():
    jp = jax.jit(functools.partial(jssm.ssd_init, d_model=D_MODEL, head_dim=HEAD_DIM,
                                   state=STATE, conv_width=CONV))(jax.random.PRNGKey(3))
    npp = _with_random_f32_leaves(jax.tree.map(np.asarray, jp), seed=4)
    tp = params_from_jax(npp, "cpu", torch.float32)
    return jax.tree.map(jnp.asarray, npp), tp


def _with_random_f32_leaves(tree, seed):
    """Replace the zeros/ones inits of the SSM's f32 leaves by random values
    (A_log small, so the decay stays in range)."""
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


def test_ssd_block(block_params):
    jp, tp = block_params
    x = np.random.default_rng(5).standard_normal((2, 32, D_MODEL), dtype=np.float32)
    kw = dict(head_dim=HEAD_DIM, state=STATE, chunk=CHUNK, conv_width=CONV)
    want = jax.jit(functools.partial(jssm.ssd_block, **kw))(jp, jnp.asarray(x))
    got = tssm.ssd_block(tp, torch.from_numpy(x), **kw)
    _close(got, want)


def test_ssd_decode_step(block_params):
    jp, tp = block_params
    rng = np.random.default_rng(6)
    cache = {k: rng.standard_normal(v.shape, dtype=np.float32)
             for k, v in jssm.init_ssm_cache(2, 2 * D_MODEL, HEAD_DIM, STATE,
                                             CONV).items()}
    x = rng.standard_normal((2, 1, D_MODEL), dtype=np.float32)
    step = jax.jit(functools.partial(jssm.ssd_decode_step, head_dim=HEAD_DIM,
                                     state=STATE))
    want, jnew = step(jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = tssm.ssd_decode_step(tp, torch.from_numpy(x), tcache,
                               head_dim=HEAD_DIM, state=STATE)
    _close(got, want)
    for k in cache:  # updated in place
        _close(tcache[k], jnew[k])


# ---------------------------------------------------------------------------
# config copy and f32 leaves
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    j, t = jget_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.reduced().param_count() == t.reduced().param_count()
    assert (t.num_layers, t.d_model, t.d_inner, t.ssm_heads, t.ssm_head_dim,
            t.ssm_state, t.ssm_conv_width, t.ssm_chunk) == (48, 1024, 2048, 32,
                                                            64, 128, 4, 128)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", k, v


@pytest.fixture(scope="module")
def jax_init():
    """The reference's reduced mamba2 params as numpy (f32 whatever the
    config dtype: the dtype only sets the compute dtype)."""
    init = jax.jit(JLM(jget_config(ARCH).reduced()).init)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def test_cast_params_keeps_f32_leaves(jax_init):
    cfg = tget_config(ARCH).reduced()  # bf16
    params = TLM(cfg, device="cpu").init(0)
    bridged = params_from_jax(jax_init, "cpu", torch.bfloat16)
    for tree in (params, bridged):
        seen = set()
        for path, key, leaf in _leaves(tree):
            want = torch.float32 if key in tl.F32_LEAVES else torch.bfloat16
            assert leaf.dtype == want, path
            seen.add(key)
        assert {"scale", *F32_LEAVES} <= seen


def test_init_matches_reference_shapes_and_scales(jax_init):
    tp = TLM(tget_config(ARCH).reduced(dtype="float32"), device="cpu").init(0)
    jflat = {path: leaf for path, _, leaf in _leaves(jax_init)}
    tflat = {path: leaf for path, _, leaf in _leaves(tp)}
    assert sorted(jflat) == sorted(tflat)
    for path, ref in jflat.items():
        t = tflat[path]
        assert tuple(t.shape) == ref.shape, path
        # two samples' stds differ by ~1/sqrt(n) relative: allow 4 of that
        rel = max(0.1, 4 / np.sqrt(ref.size))
        assert abs(float(t.std()) - float(ref.std())) <= rel * float(ref.std()), path
        if float(ref.std()) == 0.0:  # the constant inits (zeros, ones)
            np.testing.assert_array_equal(t.numpy(), ref)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(jax_init):
    jcfg = jget_config(ARCH).reduced(dtype="float32")
    tcfg = tget_config(ARCH).reduced(dtype="float32")
    jlm = JLM(jcfg)
    npp = _with_random_f32_leaves(jax_init, seed=7)
    tlm = TLM(tcfg, device="cpu")
    tparams = params_from_jax(npp, "cpu", torch.float32)
    return jlm, jax.tree.map(jnp.asarray, npp), tlm, tparams, jax.jit(jlm.decode_step)


def _prompts(S, B=2, seed=11):
    return make_prompts(B, S, 512, seed)


def _stepped(jlm, jparams, jstep, tokens, max_seq):
    jcache = jlm.decode_init(tokens.shape[0], max_seq, dtype=jnp.float32)
    for t in range(tokens.shape[1]):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]),
                             jnp.asarray(t))
    return jlog, jcache


def test_forward_logits(models):
    jlm, jparams, tlm, tparams, _ = models
    tokens = _prompts(32)  # a multiple of the reduced chunk (16)
    want = jlm.forward_logits(jparams, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward_logits(tparams, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 512)
    _close(got, want)


def test_decode_step(models):
    jlm, jparams, tlm, tparams, jstep = models
    tokens = _prompts(6)
    jcache = jlm.decode_init(2, 6)
    tcache = tlm.decode_init(2, 6)
    assert tcache["ssm"]["state"].dtype == torch.float32
    for t in range(6):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]),
                             jnp.asarray(t))
        tlog, tcache = tlm.decode_step(tparams, tcache,
                                       torch.from_numpy(tokens[:, t]), t)
        _close(tlog, jlog)
    for k, v in jcache["ssm"].items():
        _close(tcache["ssm"][k], v)


@pytest.mark.parametrize("S", [2, 12])  # 2 < conv_width - 1: zero-padded windows
def test_prefill_matches_stepped_decode(models, S):
    """One-pass prefill == stepping decode_step over the prompt: last logits
    and every cache leaf (state and the three conv windows of each layer)."""
    jlm, jparams, tlm, tparams, jstep = models
    tokens = _prompts(S)
    jlog, jcache = _stepped(jlm, jparams, jstep, tokens, S)
    tlog, tcache = tlm.prefill(tparams, torch.from_numpy(tokens))
    assert tlog.shape == (2, 512)
    _close(tlog, jlog)
    assert sorted(tcache["ssm"]) == sorted(jcache["ssm"])
    for k, v in jcache["ssm"].items():
        assert tcache["ssm"][k].shape == v.shape and tcache["ssm"][k].dtype == torch.float32
        _close(tcache["ssm"][k], v)


def test_greedy_tokens_identical(models):
    """6 greedy tokens after the prompt: the port's serve (prefill + 5
    decode steps) against the reference stepping decode_step throughout."""
    jlm, jparams, tlm, tparams, jstep = models
    S, n = 10, 6
    tokens = _prompts(S, seed=12)
    jlog, jcache = _stepped(jlm, jparams, jstep, tokens, S + n)
    want = []
    for t in range(S, S + n):
        tok = jnp.argmax(jlog, axis=-1)
        want.append(np.asarray(tok))
        jlog, jcache = jstep(jparams, jcache, tok, jnp.asarray(t))
    out = serve(tlm, tparams, torch.from_numpy(tokens), n - 1)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(want, 1))


# ---------------------------------------------------------------------------
# bf16, as served
# ---------------------------------------------------------------------------

# rel-L2 of bf16 logits. XLA's CPU sigmoid and softplus differ from torch's
# in the last bits (in f32 too), so bf16 roundings flip from the first
# block on and the two frameworks agree only to bf16's level: ~1.3e-2 here,
# where the reference's own bf16 and f32 logits differ by ~1.8e-2.
BF16_REL_TOL = 3e-2


def _rel_l2(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_matches_reference_with_its_dtype_placement(jax_init, monkeypatch):
    """The reduced mamba2 in bf16 against ``repro.models.LM`` in bf16:
    forward logits, and decode at position S after a one-pass prefill
    against stepping the reference's decode. Meanwhile the dtypes are
    recorded where the reference sets them: prefill's conv runs in bf16,
    the scan takes f32, decode's conv runs in f32 on an f32 window, and
    the gated norm takes the f32 scan output and returns bf16."""
    seen = {"conv": set(), "scan": set(), "conv_step": set(), "norm": set()}

    def record(key, fn, pick):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen[key].add(pick(args, out))
            return out
        return wrapped

    monkeypatch.setattr(tssm, "_causal_conv", record(
        "conv", tssm._causal_conv, lambda a, out: (a[0].dtype, out.dtype)))
    monkeypatch.setattr(tssm, "_conv_step", record(
        "conv_step", tssm._conv_step, lambda a, out: (a[0].dtype, out[0].dtype)))
    monkeypatch.setattr(tssm, "_gated_norm_out", record(
        "norm", tssm._gated_norm_out, lambda a, out: (a[1].dtype, out.dtype)))
    scan = record("scan", tops.ssd_scan, lambda a, out: tuple(t.dtype for t in a))

    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jlm, tlm = JLM(jcfg), TLM(tcfg, device="cpu", ssd_scan=scan)
    npp = _with_random_f32_leaves(jax_init, seed=7)
    jparams = jax.tree.map(jnp.asarray, npp)
    tparams = params_from_jax(npp, "cpu", torch.bfloat16)
    S = 16  # the reduced chunk
    tokens = _prompts(S + 1, seed=13)

    want = jlm.forward_logits(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    got = tlm.forward_logits(tparams, torch.from_numpy(tokens[:, :S]))
    assert got.dtype == torch.float32
    assert _rel_l2(got, want) <= BF16_REL_TOL

    jlog, _ = _stepped(jlm, jparams, jax.jit(jlm.decode_step), tokens, S + 1)
    _, tcache = tlm.prefill(tparams, torch.from_numpy(tokens[:, :S]), max_seq=S + 1)
    tlog, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tokens[:, S]), S)
    assert all(v.dtype == torch.float32 for v in tcache["ssm"].values())
    assert _rel_l2(tlog, jlog) <= BF16_REL_TOL

    f32, bf16 = torch.float32, torch.bfloat16
    assert seen["conv"] == {(bf16, bf16)}
    assert seen["scan"] == {(f32,) * 5}
    assert seen["conv_step"] == {(f32, f32)}
    assert seen["norm"] == {(f32, bf16)}
