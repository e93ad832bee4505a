"""The port's hybrid-family LM (zamba2-7b: Mamba2 blocks and one shared
attention block after every ``hybrid_attn_period`` of them) against the JAX
package's, on the CPU: in f32, and once in bf16 as the model is served.

Two reduced configs: ``reduced()`` itself (4 layers in 2 groups of 2, no
tail) and one with a tail like zamba2-7b's 81 = 13 x 6 + 3 (7 layers in 2
groups of 3, then 1). The reference is built with ``use_flash=True``, its
weights are initialised by JAX, given random f32 leaves (dt_bias, A_log,
D, norm_scale) so that those paths are exercised, and carried over with
``params_from_jax``; inputs are made with numpy. Tolerance 1e-4 (rtol and
atol): the frameworks sum in other orders, and the reference scans in
chunks where the port's CPU path steps token by token. On the CPU the
port's attention and SSD scan run the kernels' plain versions; the
kernels are held against them in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.serve import make_prompts, serve  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-4
ARCH = "zamba2-7b"
# reduced-config overrides: none (2 groups of 2, no tail), and a tail group
SHAPES = {"no_tail": {}, "tail": dict(num_layers=7, hybrid_attn_period=3)}
F32_LEAVES = ("dt_bias", "A_log", "D", "norm_scale")


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _flat(tree) -> dict:
    return {".".join(path): leaf for path, leaf in named_leaves(tree)}


def _with_random_f32_leaves(tree, seed):
    """The zeros/ones inits of the SSM's f32 leaves replaced by random
    values (A_log and dt_bias small, so the decay stays in range)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in F32_LEAVES:
                scale = 0.3 if k in ("A_log", "dt_bias") else 1.0
                base = 1.0 if k in ("D", "norm_scale") else 0.0
                out[k] = (base + scale * rng.standard_normal(v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(tree)


def _prompts(S, B=2, seed=11):
    return make_prompts(B, S, 512, seed)


# ---------------------------------------------------------------------------
# config copy
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    j, t = jget_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    for over in SHAPES.values():
        assert dataclasses.asdict(j.reduced(**over)) == dataclasses.asdict(t.reduced(**over))
        assert j.reduced(**over).param_count() == t.reduced(**over).param_count()
    assert (t.family, t.num_layers, t.hybrid_attn_period, t.d_model, t.head_dim,
            t.num_heads, t.num_kv_heads, t.ssm_heads, t.ssm_head_dim, t.ssm_state,
            t.ssm_chunk) == ("hybrid", 81, 6, 3584, 112, 32, 32, 112, 64, 64, 128)
    assert divmod(t.num_layers, t.hybrid_attn_period) == (13, 3)
    assert (t.reduced().num_layers, t.reduced().hybrid_attn_period) == (4, 2)


def test_full_size_cache_layout():
    """decode_init at zamba2-7b's full size: the reference's names and
    layouts, one KV slot a group of 6 and the tail's own SSM cache."""
    cfg = tget_config(ARCH)
    cache = TLM(cfg, device="cpu").decode_init(1, 3)
    want = JLM(jget_config(ARCH)).decode_init(1, 3)
    assert sorted(cache) == sorted(want) == ["kv", "ssm", "ssm_tail"]
    for path, leaf in _flat(cache).items():
        ref = _flat(want)[path]
        assert tuple(leaf.shape) == ref.shape, path
        assert leaf.dtype == (torch.bfloat16 if path.startswith("kv") else torch.float32)
    assert cache["kv"]["k"].shape == (13, 1, 3, 32, 112)
    assert cache["ssm"]["state"].shape == (78, 1, 112, 64, 64)
    assert cache["ssm_tail"]["state"].shape == (3, 1, 112, 64, 64)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(SHAPES))
def jax_init(request):
    """(overrides, the reference's reduced params as numpy, f32 whatever
    the config dtype: the dtype only sets the compute dtype)."""
    over = SHAPES[request.param]
    init = jax.jit(JLM(jget_config(ARCH).reduced(**over)).init)
    return over, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def test_init_matches_reference_shapes_and_scales(jax_init):
    over, jp = jax_init
    tp = TLM(tget_config(ARCH).reduced(dtype="float32", **over), device="cpu").init(0)
    jflat, tflat = _flat(jp), _flat(tp)
    assert sorted(jflat) == sorted(tflat)
    assert ("tail_layers.ssd.w_x" in tflat) == bool(over)
    assert tflat["shared_attn.attn.wq"].shape == (128, 4 * 32)  # one block, unstacked
    for path, ref in jflat.items():
        t = tflat[path]
        assert tuple(t.shape) == ref.shape, path
        # two samples' stds differ by ~1/sqrt(n) relative: allow 4 of that
        rel = max(0.1, 4 / np.sqrt(ref.size))
        assert abs(float(t.std()) - float(ref.std())) <= rel * float(ref.std()), path
        if float(ref.std()) == 0.0:  # the constant inits (zeros, ones)
            np.testing.assert_array_equal(t.numpy(), ref)


def test_init_keeps_f32_leaves(jax_init):
    over, jp = jax_init
    cfg = tget_config(ARCH).reduced(**over)  # bf16
    for tree in (TLM(cfg, device="cpu").init(0), params_from_jax(jp, "cpu", torch.bfloat16)):
        for path, leaf in _flat(tree).items():
            want = torch.float32 if path.split(".")[-1] in tl.F32_LEAVES else torch.bfloat16
            assert leaf.dtype == want, path


# ---------------------------------------------------------------------------
# the model, f32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(jax_init):
    over, jp = jax_init
    jcfg = jget_config(ARCH).reduced(dtype="float32", **over)
    tcfg = tget_config(ARCH).reduced(dtype="float32", **over)
    jlm = JLM(jcfg, use_flash=True)
    npp = _with_random_f32_leaves(jp, seed=7)
    tlm = TLM(tcfg, device="cpu")
    tparams = params_from_jax(npp, "cpu", torch.float32)
    return jlm, jax.tree.map(jnp.asarray, npp), tlm, tparams, jax.jit(jlm.decode_step)


def _stepped(jlm, jparams, jstep, tokens, max_seq):
    jcache = jlm.decode_init(tokens.shape[0], max_seq, dtype=jnp.float32)
    for t in range(tokens.shape[1]):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]), jnp.asarray(t))
    return jlog, jcache


def _counting(fn, calls, key):
    def wrapped(*args, **kw):
        calls[key] += 1
        return fn(*args, **kw)
    return wrapped


def test_forward_logits(models):
    """Forward logits within 1e-4, with the shared block called once a
    group and a scan for every Mamba block, tail included."""
    jlm, jparams, tlm, tparams, _ = models
    cfg = tlm.cfg
    calls = {"attention": 0, "ssd_scan": 0}
    lm = TLM(cfg, device="cpu",
             attention=_counting(tops.flash_attention, calls, "attention"),
             ssd_scan=_counting(tops.ssd_scan, calls, "ssd_scan"))
    tokens = _prompts(32)  # a multiple of the reduced chunk (16)
    want = jlm.forward_logits(jparams, {"tokens": jnp.asarray(tokens)})
    got = lm.forward_logits(tparams, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 512)
    _close(got, want)
    assert calls == {"attention": cfg.num_layers // cfg.hybrid_attn_period,
                     "ssd_scan": cfg.num_layers}


def test_decode_step(models):
    jlm, jparams, tlm, tparams, jstep = models
    tokens = _prompts(6)
    jcache = jlm.decode_init(2, 6, dtype=jnp.float32)
    tcache = tlm.decode_init(2, 6, dtype=torch.float32)
    for t in range(6):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]), jnp.asarray(t))
        tlog, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tokens[:, t]), t)
        _close(tlog, jlog)
    jflat = _flat(jax.tree.map(np.asarray, jcache))
    assert sorted(_flat(tcache)) == sorted(jflat)
    for path, leaf in _flat(tcache).items():
        _close(leaf, jflat[path])


@pytest.mark.parametrize("S", [2, 12])  # 2 < conv_width - 1: zero-padded windows
def test_prefill_matches_stepped_decode(models, S):
    """One-pass prefill == stepping decode_step over the prompt: last logits
    and every cache leaf (each Mamba block's state and conv windows, the
    shared block's k/v in each group's slot, the tail's SSM cache)."""
    jlm, jparams, tlm, tparams, jstep = models
    extra = 5
    tokens = _prompts(S)
    jlog, jcache = _stepped(jlm, jparams, jstep, tokens, S + extra)
    tlog, tcache = tlm.prefill(tparams, torch.from_numpy(tokens), max_seq=S + extra,
                               cache_dtype=torch.float32)
    assert tlog.shape == (2, 512)
    _close(tlog, jlog)
    jflat = _flat(jax.tree.map(np.asarray, jcache))
    tflat = _flat(tcache)
    assert sorted(tflat) == sorted(jflat)
    assert ("ssm_tail.state" in tflat) == (tlm.cfg.num_layers % tlm.cfg.hybrid_attn_period > 0)
    for path, leaf in tflat.items():
        assert tuple(leaf.shape) == jflat[path].shape and leaf.dtype == torch.float32, path
        _close(leaf, jflat[path])


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

def _rel_l2(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_matches_reference_with_its_dtype_placement(monkeypatch):
    """The reduced zamba2 with a tail in bf16 against ``repro.models.LM`` in
    bf16: forward logits, and decode at position S after a one-pass
    prefill against stepping the reference's decode. The frameworks agree
    only to bf16's level (XLA's CPU sigmoid and softplus differ from
    torch's in the last bits, so bf16 roundings flip from the first block
    on), so the limit is set by the reference's own bf16 rounding: the
    port's bf16 logits may be no farther (rel-L2) from the reference's bf16
    ones than twice the distance of those from the reference's f32 logits
    on the same weights. Across seeds that distance reads 0.023-0.058 and
    the port's 0.022-0.045; in f32 the two agree within 1e-4 (above).
    Meanwhile the dtypes are recorded where the reference sets them:
    attention in bf16, the scan in f32, the gated norm from f32 to bf16,
    the KV cache in bf16 and the SSM caches in f32."""
    seen = {"attention": set(), "scan": set(), "norm": set()}

    def record(key, fn, pick):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen[key].add(pick(args, out))
            return out
        return wrapped

    monkeypatch.setattr(tssm, "_gated_norm_out", record(
        "norm", tssm._gated_norm_out, lambda a, out: (a[1].dtype, out.dtype)))
    attention = record("attention", tops.flash_attention,
                       lambda a, out: (*(t.dtype for t in a), out.dtype))
    scan = record("scan", tops.ssd_scan, lambda a, out: tuple(t.dtype for t in a))

    over = SHAPES["tail"]
    jcfg, tcfg = jget_config(ARCH).reduced(**over), tget_config(ARCH).reduced(**over)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jlm = JLM(jcfg, use_flash=True)
    jlm32 = JLM(jget_config(ARCH).reduced(dtype="float32", **over), use_flash=True)
    tlm = TLM(tcfg, device="cpu", attention=attention, ssd_scan=scan)
    npp = _with_random_f32_leaves(jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(1))), 8)
    jparams = jax.tree.map(jnp.asarray, npp)
    tparams = params_from_jax(npp, "cpu", torch.bfloat16)
    S = 16  # the reduced chunk
    tokens = _prompts(S + 1, seed=13)

    batch = {"tokens": jnp.asarray(tokens[:, :S])}
    want, want32 = jlm.forward_logits(jparams, batch), jlm32.forward_logits(jparams, batch)
    got = tlm.forward_logits(tparams, torch.from_numpy(tokens[:, :S]))
    assert got.dtype == torch.float32
    assert _rel_l2(got, want) <= 2 * _rel_l2(torch.from_numpy(np.asarray(want, np.float32)),
                                             want32)

    jlogs = []
    for lm, dtype in ((jlm, jnp.bfloat16), (jlm32, jnp.float32)):
        jcache, jstep = lm.decode_init(2, S + 1, dtype=dtype), jax.jit(lm.decode_step)
        for t in range(S + 1):
            jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]), jnp.asarray(t))
        jlogs.append(jlog)
    _, tcache = tlm.prefill(tparams, torch.from_numpy(tokens[:, :S]), max_seq=S + 1)
    tlog, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tokens[:, S]), S)
    assert _rel_l2(tlog, jlogs[0]) <= 2 * _rel_l2(
        torch.from_numpy(np.asarray(jlogs[0], np.float32)), jlogs[1])
    for path, leaf in _flat(tcache).items():
        assert leaf.dtype == (torch.bfloat16 if path.startswith("kv") else torch.float32), path

    f32, bf16 = torch.float32, torch.bfloat16
    assert seen["attention"] == {(bf16,) * 4}
    assert seen["scan"] == {(f32,) * 5}
    assert seen["norm"] == {(f32, bf16)}
