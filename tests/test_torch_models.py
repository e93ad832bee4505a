"""The port's dense LM against the JAX package's, in f32 on the CPU.

Weights are initialised by JAX and carried over with ``params_from_jax``;
inputs are made with numpy. Tolerance 1e-4 (rtol and atol): the two
frameworks sum in other orders.
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
from repro.models import layers as jl  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch.serve import make_prompts, serve  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = 1e-4
DENSE_ARCHS = ("llama3.2-1b", "chatglm3-6b", "internlm2-20b", "h2o-danube-3-4b")
VARIANTS = {  # name: (arch, overrides of its reduced config)
    "llama": ("llama3.2-1b", {}),
    # window shorter than the prompt (ring cache), softcap, partial rotary
    "swa_softcap_partial_rope": ("llama3.2-1b", dict(
        sliding_window=8, attn_logit_softcap=30.0, rotary_pct=0.5)),
    # the other dense configs as reduced(): chatglm3's partial rotary,
    # internlm2's and h2o-danube's untied unembedding, h2o-danube's window
    # (4096, wider than these prompts: the ring cache is the variant above's)
    **{arch: (arch, {}) for arch in DENSE_ARCHS[1:]},
}


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# config copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS + ("whisper-medium", "llava-next-34b"))
def test_config_copy_matches_reference(arch):
    j, t = jget_config(arch), tget_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.reduced().param_count() == t.reduced().param_count()
    assert t.family == {"whisper-medium": "encdec", "llava-next-34b": "vlm"}.get(arch, "dense")


def test_dense_configs_take_the_kernel_routes_they_are_checked_on():
    """Head dims of the dense configs as the card serves them in bf16: all
    on the wgmma route, hd 64 / 128 and h2o-danube's 120 (the hd-128
    instance, zero-padded)."""
    got = {arch: (tget_config(arch).head_dim, tget_config(arch).num_kv_heads,
                  tget_config(arch).rotary_pct, tget_config(arch).sliding_window,
                  tfa.route(torch.bfloat16, tget_config(arch).head_dim))
           for arch in DENSE_ARCHS}
    assert got == {"llama3.2-1b": (64, 8, 1.0, 0, "wgmma"),
                   "chatglm3-6b": (128, 2, 0.5, 0, "wgmma"),
                   "internlm2-20b": (128, 8, 1.0, 0, "wgmma"),
                   "h2o-danube-3-4b": (120, 8, 1.0, 4096, "wgmma")}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    s = rng.standard_normal((64,), dtype=np.float32)
    want = jl.rms_norm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-5)
    got = tl.rms_norm({"scale": torch.from_numpy(s)}, torch.from_numpy(x), 1e-5)
    _close(got, want)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_rope_interleaved_pairs(rotary_pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos = np.arange(3, 10)
    jc, js, jr = jl.rope_tables(jnp.asarray(pos), 32, 5e5, rotary_pct)
    tc, ts, tr = tl.rope_tables(torch.from_numpy(pos), 32, 5e5, rotary_pct)
    assert jr == tr and tc.dtype == torch.float32
    _close(tc, jc)
    _close(ts, js)
    want = jl.apply_rope(jnp.asarray(x), jc, js, jr)
    got = tl.apply_rope(torch.from_numpy(x), tc, ts, tr)
    _close(got, want)
    # pairs are (0, 1), (2, 3), ...: a half-split rotation would differ
    half = torch.from_numpy(x)[..., :tr // 2]
    assert not torch.allclose(got[..., :tr // 2], half * tc[..., None, :tr // 2])


def test_swiglu():
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in
         (("gate", (32, 48)), ("up", (32, 48)), ("down", (48, 32)))}
    x = rng.standard_normal((2, 4, 32), dtype=np.float32)
    want = jl.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tl.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_unembed(dtype):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16), dtype=np.float32) * 0.02
    w = rng.standard_normal((16, 50), dtype=np.float32)
    tokens = rng.integers(0, 50, (2, 6))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens), jd)
    tx = tl.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tokens), td)
    assert tx.dtype == td
    _close(tx, jx, tol=0)
    for jfn, tfn, p in ((jl.unembed, tl.unembed, {"table": table}),
                        (jl.unembed_separate, tl.unembed_separate, {"w": w})):
        want = jfn({k: jnp.asarray(v) for k, v in p.items()}, jx)
        got = tfn({k: torch.from_numpy(v) for k, v in p.items()}, tx)
        assert got.dtype == torch.float32  # f32 logits from bf16 operands too
        _close(got, want)


def test_init_distributions():
    """The port's seeded init draws N(0, 1/fan_in) weights, 0.02 embeddings
    and unit norm scales, with the reference's shapes."""
    cfg = tget_config("llama3.2-1b").reduced(dtype="float32")
    jp = jax.tree.map(np.asarray, JLM(jget_config("llama3.2-1b").reduced(
        dtype="float32")).init(jax.random.PRNGKey(0)))
    tp = TLM(cfg, device="cpu").init(0)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(jflat) == 11
    for path, ref in jflat.items():
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == ref.shape
        assert abs(float(t.std()) - float(ref.std())) < 0.1 * float(ref.std()) + 1e-6
    assert torch.equal(tp["layers"]["ln1"]["scale"], torch.ones(2, 128))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-370m"])
def test_init_casts_each_leaf_as_drawn(arch):
    """``LM.init`` in bf16 casts each leaf right after its draw: the params
    are bit for bit an f32 draw cast once at the end, and the f32 leaves
    stay f32."""
    lm = TLM(tget_config(arch).reduced(), device="cpu")  # bf16
    got = named_leaves(lm.init(3))
    want = named_leaves(tl.cast_params(lm.init(3, param_dtype=torch.float32), torch.bfloat16))
    assert [path for path, _ in got] == [path for path, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == (torch.float32 if path[-1] in tl.F32_LEAVES
                                      else torch.bfloat16), path
        assert torch.equal(g, w), path


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    arch, over = VARIANTS[request.param]
    over = dict(dtype="float32", **over)
    jcfg = jget_config(arch).reduced(**over)
    tcfg = tget_config(arch).reduced(**over)
    jlm = JLM(jcfg, use_flash=True)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = TLM(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                              torch.float32)
    return jlm, jparams, tlm, tparams, jax.jit(jlm.decode_step)


def _prompts(S, B=2, seed=11):
    return make_prompts(B, S, 512, seed)


def test_forward_logits(models):
    jlm, jparams, tlm, tparams, _ = models
    tokens = _prompts(24)
    want = jlm.forward_logits(jparams, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward_logits(tparams, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 512)
    _close(got, want)


def test_decode_step(models):
    jlm, jparams, tlm, tparams, jstep = models
    tokens = _prompts(6)
    jcache = jlm.decode_init(2, 6, dtype=jnp.float32)
    tcache = tlm.decode_init(2, 6, dtype=torch.float32)
    for t in range(6):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]),
                             jnp.asarray(t))
        tlog, tcache = tlm.decode_step(tparams, tcache,
                                       torch.from_numpy(tokens[:, t]), t)
        _close(tlog, jlog)
    _close(tcache["kv"]["k"], jcache["kv"]["k"])


def test_prefill_matches_stepped_decode(models):
    """One-pass prefill == serve_batch's stepping of decode_step over the
    prompt: last logits and every cache entry (f32 cache)."""
    jlm, jparams, tlm, tparams, jstep = models
    S, extra = 12, 8
    tokens = _prompts(S)
    jcache = jlm.decode_init(2, S + extra, dtype=jnp.float32)
    for t in range(S):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]),
                             jnp.asarray(t))
    tfa.flash_attention.launches = 0
    tlog, tcache = tlm.prefill(tparams, torch.from_numpy(tokens),
                               max_seq=S + extra, cache_dtype=torch.float32)
    assert tfa.flash_attention.launches == 0  # CPU: the plain version
    assert tlog.shape == (2, 512) and tcache["kv"]["k"].dtype == torch.float32
    _close(tlog, jlog)
    for name in ("k", "v"):
        assert tcache["kv"][name].shape == jcache["kv"][name].shape
        _close(tcache["kv"][name], jcache["kv"][name])


def test_greedy_tokens_identical(models):
    """8 greedy tokens after the prompt: the port's serve (prefill + 7
    decode steps) against the reference stepping decode_step throughout."""
    jlm, jparams, tlm, tparams, jstep = models
    S, n = 10, 8
    tokens = _prompts(S, seed=12)
    jcache = jlm.decode_init(2, S + n, dtype=jnp.float32)
    for t in range(S):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]),
                             jnp.asarray(t))
    want = []
    for t in range(S, S + n):
        tok = jnp.argmax(jlog, axis=-1)
        want.append(np.asarray(tok))
        jlog, jcache = jstep(jparams, jcache, tok, jnp.asarray(t))
    # the reference's cache is f32 here; so is the port's (config dtype)
    out = serve(tlm, tparams, torch.from_numpy(tokens), n - 1)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(want, 1))


def test_prefill_cache_defaults_to_config_dtype(models):
    _, _, tlm, tparams, _ = models
    _, cache = tlm.prefill(tparams, torch.from_numpy(_prompts(4)))
    assert cache["kv"]["k"].dtype == torch.float32
    assert tlm.decode_init(1, 4)["kv"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=5, offset=3),
                                dict(causal=True, offset=7)])
def test_attend_with_scores_mask(kw):
    """Dense GQA attention under the additive mask, as decode uses it."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 6, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 10, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 10, 2, 16), dtype=np.float32)
    jm = ja.gqa_scores_mask(6, 10, **kw)
    tm = ta.gqa_scores_mask(6, 10, **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = ja.attend(*(jnp.asarray(a) for a in (q, k, v)), jm, softcap=30.0)
    got = ta.attend(*(torch.from_numpy(a) for a in (q, k, v)), tm, softcap=30.0)
    _close(got, want)
