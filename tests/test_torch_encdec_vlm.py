"""The port's encdec (whisper-medium: a bidirectional encoder over stub
audio frames, a causal decoder with cross-attention) and vlm (llava-next-34b:
the dense decoder over stub image patches ahead of the tokens) LMs against
the JAX package's, in f32 on the CPU.

Four reduced configs: whisper's ``reduced()`` (8 frames), one with a
ragged encoder of 40 frames, llava's ``reduced()`` (4 patches) and one with
37 patches; no P + S here is a multiple of the reference's 512-position
padding. The reference is built with ``use_flash=True`` (its encoder and
self-attention in Pallas interpret mode, its cross-attention through
``attend``) for logits and decode, and without it for the loss and its
gradients (the Pallas kernel has no VJP). Its weights are initialised by
JAX and carried over with ``params_from_jax``; inputs are made with numpy.
Tolerance 1e-4 (rtol and atol): the frameworks sum in other orders. On the
CPU the port's attention runs the flash kernels' plain versions; the
kernels are held against them in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.data.pipeline import stub_inputs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.serve import make_prompts, serve  # noqa: E402
from repro_torch.launch.train_lm import _tree_like  # noqa: E402
from repro_torch.configs import REGISTRY as TREGISTRY  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-4
VARIANTS = {  # name: (arch, overrides of its reduced config)
    "whisper": ("whisper-medium", {}),
    "whisper_ragged": ("whisper-medium", dict(encoder_seq=40)),
    "llava": ("llava-next-34b", {}),
    "llava_37_patches": ("llava-next-34b", dict(num_patches=37)),
}
S = 12  # prompt tokens


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    arch, over = VARIANTS[request.param]
    over = dict(dtype="float32", **over)
    jcfg = jget_config(arch).reduced(**over)
    tcfg = tget_config(arch).reduced(**over)
    jlm = JLM(jcfg, use_flash=True)
    jparams = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    tlm = TLM(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jlm, jparams, tlm, tparams


def _prompts(n, B=2, seed=11):
    return make_prompts(B, n, 512, seed)


def _stub(cfg, B=2, seed=3):
    """The family's stub input: numpy for the reference, torch for the port."""
    x = stub_inputs(cfg, B, seed)
    return x, {k: torch.from_numpy(v) for k, v in x.items()}


def _prefix(cfg) -> int:
    return cfg.num_patches if cfg.family == "vlm" else 0


def _ref_cross_cache(jlm, jparams, frames, dtype=jnp.float32):
    """The reference's decode cross cache filled by its own encoder and
    ``encode_cross_kv``: nothing in the reference fills it."""
    c = jlm.cfg
    enc = jlm._encode(jparams, jnp.asarray(frames))
    ks, vs = [], []
    for i in range(c.num_layers):
        lp = jax.tree.map(lambda a: a[i], jparams["layers"]["xattn"])
        k, v = jattn.encode_cross_kv(lp, enc, num_kv_heads=c.num_kv_heads,
                                     head_dim=c.head_dim)
        ks.append(k)
        vs.append(v)
    return {"k": jnp.stack(ks).astype(dtype), "v": jnp.stack(vs).astype(dtype)}


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

def test_forward_logits(models):
    """The tokens' logits (the vlm's patch positions left out, as the
    reference slices them) and the prefill's last logits."""
    jlm, jparams, tlm, tparams = models
    tokens = _prompts(S)
    jstub, tstub = _stub(tlm.cfg)
    want = jax.jit(jlm.forward_logits)(
        jparams, {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in jstub.items()}})
    got = tlm.forward_logits(tparams, torch.from_numpy(tokens), **tstub)
    assert got.dtype == torch.float32 and got.shape == (2, S, 512) == want.shape
    _close(got, want)
    last, cache = tlm.prefill(tparams, torch.from_numpy(tokens), **tstub)
    _close(last, want[:, -1])
    assert cache["kv"]["k"].shape[2] == _prefix(tlm.cfg) + S


def test_loss_and_grads_match_jax(models):
    """``LM.loss``, its ``xent`` and every gradient leaf (the encoder's,
    ``enc_ln``'s, ``ln_x``'s and ``xattn``'s included) against
    ``jax.value_and_grad`` of the reference's loss, f32, 1e-4. The vlm's
    reference pads the sequence and masks the patch and pad labels; the
    port takes logits at the token positions only."""
    jlm, jparams, tlm, _ = models
    tokens = _prompts(S, seed=5)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    jstub, tstub = _stub(tlm.cfg, seed=6)
    batch = {"tokens": tokens, "labels": labels}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        JLM(jlm.cfg).loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in {**batch, **jstub}.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    loss, metrics = tlm.loss(params, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                                      **tstub})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    assert float(metrics["xent"]) == pytest.approx(float(jmetrics["xent"]), rel=TOL)
    assert float(metrics["moe_aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    paths = [path for path, _ in named_leaves(params)]
    assert [tuple(k.key for k in path) for path, _ in jleaves] == paths
    if tlm.cfg.family == "encdec":
        for want in (("enc_layers", "attn", "wq"), ("enc_ln", "scale"),
                     ("layers", "ln_x", "scale"), ("layers", "xattn", "wk")):
            assert want in paths
    for (path, jg), g in zip(jleaves, grads):
        assert float(g.abs().max()) > 0, path
        _close(g, jg)


def test_remat_is_bit_equal(models):
    _, _, tlm, tparams = models
    tokens = torch.from_numpy(_prompts(S, seed=6))
    _, tstub = _stub(tlm.cfg, seed=7)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1), **tstub}
    out = []
    for remat in (False, True):
        leaves = [t.detach().clone().requires_grad_(True) for _, t in named_leaves(tparams)]
        params = _tree_like(tparams, iter(leaves))
        loss, _ = TLM(tlm.cfg, device="cpu", remat=remat).loss(params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_decode_steps_match_reference(models):
    """The port prefills S tokens and steps decode over 4 more; each step's
    logits against the reference's forward at that position, and in
    the encdec family also against the reference's own ``decode_step``
    stepped from position 0 over a cross cache its encoder filled."""
    jlm, jparams, tlm, tparams = models
    n = 4
    tokens = _prompts(S + n, seed=8)
    jstub, tstub = _stub(tlm.cfg, seed=9)
    jstub = {k: jnp.asarray(v) for k, v in jstub.items()}
    P = _prefix(tlm.cfg)
    last, cache = tlm.prefill(tparams, torch.from_numpy(tokens[:, :S]), max_seq=P + S + n,
                              **tstub)
    steps = [last]
    for i in range(n):
        logits, cache = tlm.decode_step(tparams, cache, torch.from_numpy(tokens[:, S + i]),
                                        P + S + i)
        steps.append(logits)
    # the reference's causal forward over all S + n tokens: position t's
    # logits are those of a forward over the first t + 1
    want = jax.jit(jlm.forward_logits)(jparams, {"tokens": jnp.asarray(tokens), **jstub})
    for i, got in enumerate(steps):
        _close(got, want[:, S - 1 + i])
    if tlm.cfg.family != "encdec":
        return
    jcache = jlm.decode_init(2, S + n, dtype=jnp.float32)
    jcache["cross"] = _ref_cross_cache(jlm, jparams, jstub["frames"])
    jstep = jax.jit(jlm.decode_step)
    for t in range(S + n):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]), jnp.asarray(t))
        if t >= S - 1:
            _close(steps[t - S + 1], jlog)
    _close(cache["cross"]["k"], jcache["cross"]["k"])
    _close(cache["kv"]["v"], jcache["kv"]["v"])


def test_prefill_then_decode_equals_a_longer_prefill(models):
    """Decode at position P + S from the prefilled cache (the cross cache
    included) gives the logits and the cache of a prefill one token
    longer; decode from position S instead misses it in the vlm family."""
    _, _, tlm, tparams = models
    tokens = torch.from_numpy(_prompts(S + 1, seed=10))
    _, tstub = _stub(tlm.cfg, seed=11)
    P = _prefix(tlm.cfg)
    _, cache = tlm.prefill(tparams, tokens[:, :S], max_seq=P + S + 1, **tstub)
    step, cache = tlm.decode_step(tparams, cache, tokens[:, S], P + S)
    longer, lcache = tlm.prefill(tparams, tokens, **tstub)
    _close(step, longer)
    for name in ("k", "v"):
        _close(cache["kv"][name], lcache["kv"][name])
        if "cross" in cache:
            assert torch.equal(cache["cross"][name], lcache["cross"][name])
    if P:
        _, cache = tlm.prefill(tparams, tokens[:, :S], max_seq=P + S + 1, **tstub)
        wrong, _ = tlm.decode_step(tparams, cache, tokens[:, S], S)
        assert float((wrong - longer).abs().max()) > 100 * TOL


@pytest.mark.parametrize("models", ["whisper", "whisper_ragged"], indirect=True)
def test_reference_cross_cache_is_zero_pinned(models):
    """The reference's ``decode_init`` returns a zero cross cache and nothing
    in the reference fills it, so its encdec ``decode_step`` ignores the
    audio unless the caller fills the cache: from the zero cache it misses
    its own filled-cache logits. The port's ``prefill`` fills it."""
    jlm, jparams, tlm, tparams = models
    jcache = jlm.decode_init(2, 4, dtype=jnp.float32)
    assert set(jcache) == {"kv", "cross"}
    c = jlm.cfg
    assert jcache["cross"]["k"].shape == (c.num_layers, 2, c.encoder_seq, c.num_kv_heads,
                                          c.head_dim)
    assert not np.asarray(jcache["cross"]["k"]).any()
    assert not np.asarray(jcache["cross"]["v"]).any()
    jstub, tstub = _stub(tlm.cfg, seed=12)
    tok = jnp.asarray(_prompts(1, seed=13)[:, 0])
    jstep = jax.jit(jlm.decode_step)
    zero, _ = jstep(jparams, jcache, tok, jnp.asarray(0))
    jcache["cross"] = _ref_cross_cache(jlm, jparams, jstub["frames"])
    filled, _ = jstep(jparams, jcache, tok, jnp.asarray(0))
    assert float(jnp.abs(zero - filled).max()) > 100 * TOL
    _, cache = tlm.prefill(tparams, torch.from_numpy(np.asarray(tok))[:, None], **tstub)
    assert cache["cross"]["k"].abs().max() > 0
    _close(cache["cross"]["k"], jcache["cross"]["k"])


@pytest.mark.parametrize("models", ["llava", "llava_37_patches"], indirect=True)
def test_vlm_sequence_is_not_padded(models):
    """The reference right-pads the vlm's P + S positions to a multiple of
    512 (``_pad_seq``); the port does not, and its logits and loss equal
    the reference's (test_forward_logits, test_loss_and_grads_match_jax):
    under the causal mask the padded tail reaches no real position."""
    jlm, _, tlm, tparams = models
    P = tlm.cfg.num_patches
    padded, true_len = jlm._pad_seq(jnp.zeros((2, P + S, tlm.cfg.d_model)))
    assert (padded.shape[1], true_len) == (512, P + S)
    seen = []

    def attention(q, k, v, **kw):
        seen.append(q.shape[1])
        return tops.flash_attention(q, k, v, **kw)

    _, tstub = _stub(tlm.cfg)
    TLM(tlm.cfg, device="cpu", attention=attention).forward_logits(
        tparams, torch.from_numpy(_prompts(S)), **tstub)
    assert seen == [P + S] * tlm.cfg.num_layers


# ---------------------------------------------------------------------------
# the attention paths and the entry points
# ---------------------------------------------------------------------------

def test_every_prefill_attention_goes_through_the_kernel_entry(models):
    """Prefill runs the encoder's self-attention (non-causal), the
    decoder's (causal) and the cross-attention (non-causal, T frames)
    through ``attention``, the function the kernel comparisons swap for
    the plain version; decode runs none of them."""
    _, _, tlm, tparams = models
    c = tlm.cfg
    calls = []

    def attention(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return tops.flash_attention(q, k, v, **kw)

    lm = TLM(c, device="cpu", attention=attention)
    _, tstub = _stub(c)
    tokens = torch.from_numpy(_prompts(S))
    _, cache = lm.prefill(tparams, tokens, max_seq=_prefix(c) + S + 1, **tstub)
    if c.family == "encdec":
        T = c.encoder_seq
        want = [(T, T, False)] * c.encoder_layers + [(S, S, True), (S, T, False)] * c.num_layers
    else:
        want = [(c.num_patches + S, c.num_patches + S, True)] * c.num_layers
    assert calls == want
    calls.clear()
    lm.decode_step(tparams, cache, tokens[:, 0], _prefix(c) + S)
    assert calls == []


def test_cross_attention_is_attend_with_a_zero_mask():
    """The port's cross-attention by each of its three paths (the kernel
    entry, the training autograd function, decode's ``attend``) against
    the reference's ``cross_attention``, f32, T != S, GQA."""
    rng = np.random.default_rng(0)
    d, H, KV, hd, B, Sq, T = 32, 4, 2, 8, 2, 5, 9
    p = {k: rng.standard_normal(s, dtype=np.float32) / np.sqrt(s[0]) for k, s in
         (("wq", (d, H * hd)), ("wk", (d, KV * hd)), ("wv", (d, KV * hd)), ("wo", (H * hd, d)))}
    x = rng.standard_normal((B, Sq, d), dtype=np.float32)
    enc = rng.standard_normal((B, T, d), dtype=np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jkv = jattn.encode_cross_kv(jp, jnp.asarray(enc), num_kv_heads=KV, head_dim=hd)
    want = jattn.cross_attention(jp, jnp.asarray(x), jkv, num_heads=H, head_dim=hd)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    kv = tattn.encode_cross_kv(tp, torch.from_numpy(enc), num_kv_heads=KV, head_dim=hd)
    _close(kv[0], jkv[0])
    for kw in ({}, dict(attention=tops.flash_attention),
               dict(attention=tops.flash_attention, attention_bwd=tops.flash_attention_bwd)):
        got = tattn.cross_attention(tp, torch.from_numpy(x), kv, num_heads=H, head_dim=hd, **kw)
        _close(got, want)


def test_stub_inputs_are_seeded_normals():
    for arch, name, n in (("whisper-medium", "frames", 1500),
                          ("llava-next-34b", "patches", 2880)):
        cfg = tget_config(arch).reduced(d_model=16, encoder_seq=1500, num_patches=2880)
        a, b = stub_inputs(cfg, 2, 5), stub_inputs(cfg, 2, 5)
        assert list(a) == [name] and a[name].shape == (2, n, 16)
        assert a[name].dtype == np.float32 and np.array_equal(a[name], b[name])
        assert abs(float(a[name].std()) - 1.0) < 0.01
        assert not np.array_equal(a[name], stub_inputs(cfg, 2, 6)[name])
    assert stub_inputs(tget_config("llama3.2-1b"), 2, 5) == {}


def test_stub_inputs_must_match_the_family():
    for arch, wrong in (("whisper-medium", "patches"), ("llava-next-34b", "frames"),
                        ("llama3.2-1b", "frames")):
        cfg = tget_config(arch).reduced(dtype="float32")
        lm = TLM(cfg, device="cpu")
        params = lm.init(0)
        tokens = torch.from_numpy(_prompts(4))
        with pytest.raises(ValueError, match=f"the {cfg.family} family takes"):
            lm.forward_logits(params, tokens, **{wrong: torch.zeros(2, 3, cfg.d_model)})
    cfg = tget_config("whisper-medium").reduced(dtype="float32")
    lm = TLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder_seq"):
        lm.prefill(lm.init(0), torch.from_numpy(_prompts(4)),
                   frames=torch.zeros(2, cfg.encoder_seq + 1, cfg.d_model))


@pytest.mark.parametrize("models", ["whisper", "llava"], indirect=True)
def test_serve_greedy_tokens_match_the_reference(models):
    """6 greedy tokens of the port's serve (one-pass prefill, then decode
    from position P + S) against the reference's forward over the prompt
    and the tokens generated before each, f32."""
    jlm, jparams, tlm, tparams = models
    tokens = _prompts(S, seed=14)
    jstub, tstub = _stub(tlm.cfg, seed=15)
    out = serve(tlm, tparams, torch.from_numpy(tokens), 5, **tstub)
    assert out["prefix_len"] == _prefix(tlm.cfg)
    seq = np.concatenate([tokens, out["tokens"][:, :5].numpy()], 1)
    want = jax.jit(jlm.forward_logits)(
        jparams, {"tokens": jnp.asarray(seq), **{k: jnp.asarray(v) for k, v in jstub.items()}})
    # each greedy token is the argmax of the reference's causal logits at
    # the position before it
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.argmax(want[:, S - 1:], -1)))


# ---------------------------------------------------------------------------
# the init of llava-next-34b's 68.8 GB of bf16 weights
# ---------------------------------------------------------------------------

def test_only_llavas_mlp_leaves_are_drawn_a_layer_at_a_time(monkeypatch):
    """Every stacked leaf of every config is drawn whole (its random weights
    the bits they were), but llava-next-34b's three [60, 7168, 20480] MLP
    leaves, whose f32 draws (35.2 GB each) would not fit the card beside
    the weights already drawn. Shapes recorded with ``_init`` faked."""
    drawn = []

    def fake(gen, shape, scale=None, *, stack=0, dtype=torch.float32):
        full = (stack, *shape) if stack else tuple(shape)
        drawn.append(full)
        return torch.empty(full, device="meta", dtype=dtype)

    for module in (tl, tattn, tmoe, tssm):
        monkeypatch.setattr(module, "_init", fake)
    sliced = {}
    for arch, cfg in TREGISTRY.items():
        drawn.clear()
        TLM(cfg, device="cpu").init(0)
        sliced[arch] = [s for s in drawn if np.prod(s) * 4 > tl.WHOLE_DRAW_BYTES]
    assert sliced.pop("llava-next-34b") == [(60, 7168, 20480)] * 2 + [(60, 20480, 7168)]
    assert not any(sliced.values())


def test_a_leaf_drawn_a_layer_at_a_time(monkeypatch):
    """The layer-at-a-time draw: the stacked shape and dtype, each layer
    N(0, 1/fan_in), cast once; on the CPU (whose generator fills a draw in
    order) the same bits as one whole draw."""
    whole = tl._init(torch.Generator().manual_seed(4), (256, 512), stack=3)
    monkeypatch.setattr(tl, "WHOLE_DRAW_BYTES", 0)
    sliced = tl._init(torch.Generator().manual_seed(4), (256, 512), stack=3)
    assert sliced.shape == (3, 256, 512) and torch.equal(sliced, whole)
    bf16 = tl._init(torch.Generator().manual_seed(4), (256, 512), stack=3,
                    dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, whole.bfloat16())
    for w in sliced:
        assert abs(float(w.std()) * np.sqrt(256) - 1.0) < 0.02


@pytest.mark.parametrize("argv", [["--arch", "whisper-medium", "--prompt-len", "416"],
                                  ["--arch", "llava-next-34b"]])
def test_trace_takes_the_stub_archs(monkeypatch, argv):
    """``launch.trace`` parses the two archs (whisper at its 416-token
    prompt) and, with no card, raises before it builds a model."""
    from repro_torch.launch import trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trace.main(argv)
