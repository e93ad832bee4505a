"""The port's MoE layer and moe-family LM (granite-moe-1b-a400m,
granite-moe-3b-a800m) against the JAX package's, in f32 on the CPU.

Weights are initialised by JAX and carried over with ``params_from_jax``;
inputs are made with numpy from a seed. The reference's routing is read
from its own run: ``jax.lax.top_k`` and ``jax.nn.one_hot`` are wrapped
while it is traced under ``jax.jit``, and the jitted function returns
the experts it chose and the queue slots it assigned (C where a choice
was dropped) beside its output, so the test holds the port's ``routes``
to them exactly. Outputs within 1e-5 of the largest
|value| (the two frameworks sum in other orders); the LM within 1e-4, as
the dense family's tests. The loss gradients come from
``jax.value_and_grad`` of the reference built without ``use_flash``: the
Pallas kernel has no VJP.
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch.serve import make_prompts, serve  # noqa: E402
from repro_torch.launch.train_lm import _tree_like  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
FFN_TOL = 1e-5
TOL = 1e-4


def _scaled_close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    j, t = jget_config(arch), tget_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert j.active_param_count() == t.active_param_count()
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert t.family == "moe" and t.head_dim == 64
    assert tfa.route(torch.bfloat16, t.head_dim) == "wgmma"
    assert tfa.route(torch.float32, t.head_dim) == "mma"
    for ep in (1, 3, 16):
        assert t.padded_experts(ep) == j.padded_experts(ep)


def test_config_sizes():
    got = {arch: (tget_config(arch).param_count(), tget_config(arch).num_layers,
                  tget_config(arch).num_experts, tget_config(arch).experts_per_token)
           for arch in ARCHS}
    assert got == {"granite-moe-1b-a400m": (1_334_627_328, 24, 32, 8),
                   "granite-moe-3b-a800m": (3_298_791_936, 32, 40, 8)}


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

FFN_CASES = {  # name: (B, S, d, d_ff, E, E_pad, k, capacity_factor)
    # T = 2048: two groups of 1024
    "T_multiple_of_1024": (2, 1024, 32, 16, 4, 4, 2, 1.25),
    # T = 1500: 1024 does not divide it, S does: three groups of 500
    "S_divides_T": (3, 500, 32, 16, 4, 4, 2, 1.25),
    # T = 300 < 1024: one group of all T (the reference's third branch,
    # sg = T where S does not divide T, is never taken: S divides B*S)
    "one_group_of_T": (3, 100, 32, 16, 4, 4, 2, 1.25),
    # a decode step of granite-1b's routing: B = 4 tokens, 32 experts,
    # top 8, C = int(1.25 * 4 * 8 / 32) = 1
    "decode_C1": (4, 1, 32, 16, 32, 32, 8, 1.25),
    # most choices dropped
    "capacity_0.25": (2, 64, 32, 16, 4, 4, 2, 0.25),
    # padded experts 4 -> 6: -inf logits, zero weights, never routed to
    "padded_4_to_6": (2, 48, 32, 16, 4, 6, 2, 1.25),
}


def _reference_with_routing(monkeypatch, p, x, **kw):
    """The reference's ``moe_ffn(p, x, **kw)`` under ``jax.jit`` with
    ``jax.lax.top_k`` and ``jax.nn.one_hot`` wrapped while it is traced:
    (out, aux, the chosen experts, the argument of its second one_hot, each
    choice's queue slot, C where dropped)."""
    seen = {"top_k": [], "one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(x, k):
        out = top_k(x, k)
        seen["top_k"].append(out[1])
        return out

    def rec_one_hot(x, n, **kw):
        seen["one_hot"].append(x)
        return one_hot(x, n, **kw)

    def run(p, x):
        out, aux = jmoe.moe_ffn(p, x, **kw)
        return out, aux, seen["top_k"][0], seen["one_hot"][1]

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    try:
        got = jax.jit(run)({n: jnp.asarray(v) for n, v in p.items()}, x)
    finally:
        monkeypatch.undo()
    return tuple(np.asarray(a) for a in got)


def _ffn_inputs(B, S, d, d_ff, E, E_pad, seed=0):
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), d, d_ff, E, E_pad))
    x = np.random.default_rng(seed + 1).standard_normal((B, S, d)).astype(np.float32)
    return p, x


def _run_both(monkeypatch, p, x, tp, tx, E, k, cf):
    want, want_aux, want_idx, want_slot = _reference_with_routing(
        monkeypatch, p, jnp.asarray(x), num_experts=E, experts_per_token=k, capacity_factor=cf)
    routes = []
    got, got_aux = tmoe.moe_ffn(tp, tx, num_experts=E, experts_per_token=k,
                                capacity_factor=cf, routes=routes)
    (idx, slot), = routes
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    return got, got_aux, want, want_aux, idx, slot


@pytest.mark.parametrize("name", list(FFN_CASES))
def test_moe_ffn_matches_reference(monkeypatch, name):
    B, S, d, d_ff, E, E_pad, k, cf = FFN_CASES[name]
    p, x = _ffn_inputs(B, S, d, d_ff, E, E_pad)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p.items()}
    got, got_aux, want, want_aux, idx, slot = _run_both(
        monkeypatch, p, x, tp, torch.from_numpy(x), E, k, cf)
    _scaled_close(got, want, FFN_TOL)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=FFN_TOL)
    sg = tmoe.group_size_of(B, S)
    C = tmoe.capacity_of(sg, E, k, cf)
    assert idx.shape == (B * S // sg, sg, k)
    kept = float((slot < C).float().mean())
    assert int(idx.max()) < E  # never a padded expert
    if name == "decode_C1":  # 32 pairs on 32 one-slot experts: collisions drop
        assert C == 1 and 0 < kept < 1
    elif name == "capacity_0.25":
        assert kept < 0.5
    elif name == "padded_4_to_6":
        assert p["gate"].shape[0] == 6


def test_moe_ffn_bf16_at_the_served_placement(monkeypatch):
    """x in bf16, the router f32 and the experts stored in bf16 as the
    port serves them; the reference casts its f32 weights per use to the
    same bits. Routing equal; out within bf16 rounding."""
    B, S, d, d_ff, E, E_pad, k, cf = 2, 64, 32, 16, 4, 4, 2, 1.25
    p, x = _ffn_inputs(B, S, d, d_ff, E, E_pad, seed=3)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    tp = tl.cast_params({n: torch.from_numpy(v.copy()) for n, v in p.items()}, torch.bfloat16)
    assert tp["router"].dtype == torch.float32 and tp["gate"].dtype == torch.bfloat16
    want, want_aux, want_idx, want_slot = _reference_with_routing(
        monkeypatch, p, jnp.asarray(x, jnp.bfloat16), num_experts=E, experts_per_token=k,
        capacity_factor=cf)
    routes = []
    got, got_aux = tmoe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), num_experts=E,
                                experts_per_token=k, capacity_factor=cf, routes=routes)
    assert got.dtype == torch.bfloat16 and got_aux.dtype == torch.float32
    np.testing.assert_array_equal(routes[0][0].numpy(), want_idx)
    np.testing.assert_array_equal(routes[0][1].numpy(), want_slot)
    _scaled_close(got, np.asarray(want, np.float32), 1e-2)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=FFN_TOL)


def test_moe_ffn_routing_margins():
    """The cases above route on gaps far above f32 noise: the smallest gap
    between a token's k-th and (k+1)-th router probability, printed."""
    for name, (B, S, d, d_ff, E, E_pad, k, cf) in FFN_CASES.items():
        p, x = _ffn_inputs(B, S, d, d_ff, E, E_pad)
        probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(p["router"]), -1)
        top = torch.sort(probs, -1, descending=True).values
        gap = float((top[..., k - 1] - top[..., k]).min()) if k < E else 1.0
        print(f"{name}: smallest k-th gap {gap:.3g}")
        assert gap > 1e-6


def test_moe_ffn_ties_go_to_the_lower_index():
    """Equal router logits: the reference's ``lax.top_k`` takes the lower
    expert first, and the queue places follow that order."""
    d, E, k = 8, 4, 2
    p = {"router": np.zeros((d, E), np.float32),
         "gate": np.ones((E, d, 4), np.float32), "up": np.ones((E, d, 4), np.float32),
         "down": np.ones((E, 4, d), np.float32)}
    x = np.random.default_rng(0).standard_normal((1, 6, d)).astype(np.float32)
    want, _ = jmoe.moe_ffn({n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x),
                           num_experts=E, experts_per_token=k, capacity_factor=0.5)
    routes = []
    got, _ = tmoe.moe_ffn({n: torch.from_numpy(v) for n, v in p.items()}, torch.from_numpy(x),
                          num_experts=E, experts_per_token=k, capacity_factor=0.5,
                          routes=routes)
    idx, slot = routes[0]
    assert (idx == torch.tensor([0, 1])).all()
    assert slot[0, :, 0].tolist() == [0, 1, 1, 1, 1, 1]  # C = 1: one token an expert
    _scaled_close(got, want, FFN_TOL)


@pytest.mark.parametrize("stack", [0, 3])
def test_moe_init_shapes_scales_and_pad(stack):
    d, d_ff, E, E_pad = 256, 64, 16, 24  # enough draws for 5% on each std
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, d, d_ff, E, E_pad, stack=stack, dtype=torch.bfloat16)
    lead = (stack,) if stack else ()
    assert {n: (tuple(v.shape), v.dtype) for n, v in p.items()} == {
        "router": ((*lead, d, E), torch.float32),
        "gate": ((*lead, E_pad, d, d_ff), torch.bfloat16),
        "up": ((*lead, E_pad, d, d_ff), torch.bfloat16),
        "down": ((*lead, E_pad, d_ff, d), torch.bfloat16)}
    real = (slice(None),) * bool(stack) + (slice(0, E),)
    pad = (slice(None),) * bool(stack) + (slice(E, None),)
    for name in ("gate", "up", "down"):
        assert not p[name][pad].any()
        # 1/sqrt(shape[0]) = 1/sqrt(E_pad), the reference's default, not the fan-in
        assert float(p[name][real].float().std()) == pytest.approx(1 / np.sqrt(E_pad), rel=0.05)
    assert float(p["router"].std()) == pytest.approx(1 / np.sqrt(d), rel=0.05)
    jp = jax.jit(jmoe.moe_init, static_argnums=(1, 2, 3, 4))(jax.random.PRNGKey(0), d, d_ff,
                                                              E, E_pad)
    for name, v in jp.items():
        ref = np.asarray(v)
        assert ref.shape == tuple(p[name].shape[bool(stack):])
        assert float(np.std(ref[:E] if name != "router" else ref)) == pytest.approx(
            float(p[name][real if name != "router" else ()].float().std()), rel=0.05)


# ---------------------------------------------------------------------------
# the moe-family LM
# ---------------------------------------------------------------------------

VARIANTS = {  # name: (arch, overrides of its reduced config, ep_degree)
    "granite-moe-1b-a400m": (ARCHS[0], {}, 1),
    # 3 layers; 4 experts padded to 6 by an expert-parallel degree of 3,
    # as granite-3b's 40 are padded to 48 on a 16-way axis
    "granite-moe-3b-a800m": (ARCHS[1], dict(num_layers=3), 3),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    arch, over, ep = VARIANTS[request.param]
    over = dict(dtype="float32", **over)
    jcfg = jget_config(arch).reduced(**over)
    tcfg = tget_config(arch).reduced(**over)
    jlm = JLM(jcfg, ep_degree=ep, use_flash=True)
    jparams = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    tlm = TLM(tcfg, ep_degree=ep, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jlm, jparams, tlm, tparams, jax.jit(jlm.decode_step), ep


def _prompts(S, B=2, seed=11):
    return make_prompts(B, S, 512, seed)


def _no_drop(cfg):
    """The config at capacity factor E/k: C = S_g, no choice is dropped."""
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def test_lm_pads_experts(models):
    jlm, jparams, tlm, tparams, _, ep = models
    assert tlm.e_pad == jlm.e_pad == tlm.cfg.padded_experts(ep)
    assert tuple(tparams["layers"]["moe"]["gate"].shape[:2]) == (tlm.cfg.num_layers, tlm.e_pad)
    assert "mlp" not in tparams["layers"]


def test_forward_logits(models):
    jlm, jparams, tlm, tparams, _, _ = models
    tokens = _prompts(40)
    want = jax.jit(jlm.forward_logits)(jparams, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward_logits(tparams, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 512)
    _close(got, want)
    # prefill at the configs' capacity routes the prompt as forward_logits does
    last, _ = tlm.prefill(tparams, torch.from_numpy(tokens))
    _close(last, want[:, -1])


def test_decode_step(models):
    """Stepped decode, each step one group of B tokens at C = 1."""
    jlm, jparams, tlm, tparams, jstep, _ = models
    tokens = _prompts(8)
    jcache = jlm.decode_init(2, 8, dtype=jnp.float32)
    tcache = tlm.decode_init(2, 8, dtype=torch.float32)
    for t in range(8):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]), jnp.asarray(t))
        tlog, tcache = tlm.decode_step(tparams, tcache, torch.from_numpy(tokens[:, t]), t)
        _close(tlog, jlog)
    _close(tcache["kv"]["k"], jcache["kv"]["k"])
    _close(tcache["kv"]["v"], jcache["kv"]["v"])


def test_greedy_tokens_identical_at_the_no_drop_capacity(models):
    """8 greedy tokens: the port's serve (one-pass prefill + 7 decode
    steps) against the reference stepping decode_step throughout, as its
    ``serve_batch`` serves, at the capacity where the two route alike."""
    jlm, jparams, tlm, tparams, _, ep = models
    jlm = JLM(_no_drop(jlm.cfg), ep_degree=ep, use_flash=True)
    tlm = TLM(_no_drop(tlm.cfg), ep_degree=ep, device="cpu")
    jstep = jax.jit(jlm.decode_step)
    S, n = 10, 8
    tokens = _prompts(S, seed=12)
    jcache = jlm.decode_init(2, S + n, dtype=jnp.float32)
    for t in range(S):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t]), jnp.asarray(t))
    want = []
    for t in range(S, S + n):
        tok = jnp.argmax(jlog, axis=-1)
        want.append(np.asarray(tok))
        jlog, jcache = jstep(jparams, jcache, tok, jnp.asarray(t))
    out = serve(tlm, tparams, torch.from_numpy(tokens), n - 1)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(want, 1))


def test_prefill_matches_stepped_decode_at_the_no_drop_capacity(models):
    """At C = S_g a token's routing does not depend on its group, so the
    one-pass prefill equals stepping decode_step over the prompt: last
    logits and every cache entry. At the configs' 1.25 it does not: a
    decode step's C is 1 and drops choices a prefill keeps."""
    _, _, tlm, tparams, _, ep = models
    S = 12
    tokens = torch.from_numpy(_prompts(S))
    for cfg, same in ((_no_drop(tlm.cfg), True), (tlm.cfg, False)):
        lm = TLM(cfg, ep_degree=ep, device="cpu")
        cache = lm.decode_init(2, S + 4, dtype=torch.float32)
        for t in range(S):
            step, cache = lm.decode_step(tparams, cache, tokens[:, t], t)
        tfa.flash_attention.launches = 0
        last, pcache = lm.prefill(tparams, tokens, max_seq=S + 4, cache_dtype=torch.float32)
        assert tfa.flash_attention.launches == 0  # CPU: the plain version
        if same:
            _close(last, step)
            for name in ("k", "v"):
                _close(pcache["kv"][name], cache["kv"][name])
        else:
            assert float((last - step).abs().max()) > 10 * TOL


def test_loss_and_grads_match_jax(models):
    """``LM.loss``, its ``xent`` and ``moe_aux`` (summed over the layers) and
    every gradient leaf, the router's included, against
    ``jax.value_and_grad`` of the reference's loss, f32, 1e-4."""
    jlm, jparams, tlm, tparams, _, ep = models
    tokens = _prompts(24, seed=5)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        JLM(jlm.cfg, ep_degree=ep).loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    loss, metrics = tlm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    assert float(metrics["xent"]) == pytest.approx(float(jmetrics["xent"]), rel=TOL)
    assert float(metrics["moe_aux"]) == pytest.approx(float(jmetrics["moe_aux"]), rel=TOL)
    assert float(metrics["moe_aux"]) > tlm.cfg.num_layers * 0.9  # ~1 a layer when balanced
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [tuple(k.key for k in path) for path, _ in jleaves] == \
        [path for path, _ in named_leaves(params)]
    assert ("layers", "moe", "router") in [path for path, _ in named_leaves(params)]
    for (path, jg), g in zip(jleaves, grads):
        _close(g, jg)


def test_remat_is_bit_equal(models):
    _, _, tlm, tparams, _, ep = models
    tokens = torch.from_numpy(_prompts(24, seed=6))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    out = []
    for remat in (False, True):
        leaves = [t.detach().clone().requires_grad_(True) for _, t in named_leaves(tparams)]
        params = _tree_like(tparams, iter(leaves))
        loss, metrics = TLM(tlm.cfg, ep_degree=ep, device="cpu", remat=remat).loss(params, batch)
        out.append((loss.detach(), metrics["moe_aux"].detach(),
                    torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


def test_router_stays_f32():
    """The router leaf is f32 through ``init``, ``cast_params`` and
    ``params_from_jax``, whatever the compute dtype; the experts follow it."""
    cfg = tget_config(ARCHS[0]).reduced()  # bf16
    lm = TLM(cfg, device="cpu")
    for params in (lm.init(0), tl.cast_params(lm.init(0, param_dtype=torch.float32),
                                              torch.bfloat16),
                   params_from_jax(jax.tree.map(np.asarray, jax.jit(JLM(jget_config(
                       ARCHS[0]).reduced()).init)(jax.random.PRNGKey(0))), "cpu",
                                   torch.bfloat16)):
        moe = params["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["gate"].dtype == moe["up"].dtype == moe["down"].dtype == torch.bfloat16


def test_trace_ranges_split_forward_recompute_and_backward():
    """``launch.trace.range_of`` names the MoE part of every op of a remat
    training step on the CPU: the forward and remat's recompute by their
    ``record_function`` ranges, the backward by the forward op that made
    each autograd node. The attention's ops fall outside every range."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import trace

    cfg = tget_config(ARCHS[0]).reduced(dtype="float32")
    lm = TLM(cfg, device="cpu", remat=True)
    params = lm.init(0)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    tokens = torch.from_numpy(_prompts(16, seed=7))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = lm.loss(params, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
        torch.autograd.grad(loss, leaves)
    events = list(prof.events())
    fwd = trace.forward_ranges(events)

    def via_node(e):
        """True if the nearest of a range and an autograd node is the node."""
        while e is not None:
            if e.name in trace.RANGES:
                return False
            if "Backward" in e.name and e.sequence_nr >= 0:
                return True
            e = e.cpu_parent
        return False

    seen = Counter((trace.range_of(e, fwd), via_node(e)) for e in events
                   if e.name in ("aten::bmm", "aten::mm"))
    # products of the forward and the recompute, and of the backward
    for rng in trace.RANGES:
        assert seen[(rng, False)] > 0 and seen[(rng, True)] > 0, (rng, seen)
    softmax = Counter(trace.range_of(e, fwd) for e in events if e.name == "aten::_softmax")
    assert softmax["moe.dispatch"] > 0 and softmax[None] > 0  # router; attention
