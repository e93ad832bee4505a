"""The port's training path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; model weights are initialised by
JAX and carried over with ``params_from_jax``. Where the JAX side reaches a
backward, it is ``jax.vjp`` of ``repro.kernels.ref.flash_attention_ref``
(dense) or of the reference's blockwise flash core, whose VJP is
``_flash_bwd_vjp``. On the CPU every kernel of the port runs its plain
version. Only the tiny and 10m models and reduced llama3.2-1b run here.

Tolerances, rtol = atol unless stated:
- the plain flash backward: 2e-5 in f32 and 2e-2 in bf16 (the kernel
  tests' tolerances, tests/test_kernels.py);
- the loss and its gradients in f32: 1e-4 (as tests/test_torch_models.py:
  the two frameworks sum in other orders), the loss 1e-5;
- AdamW over several steps from equal params and gradients: 1e-6;
- the DP trainer (``launch/train_lm.py``): PCCL against the built-in
  reduction 1e-6 (the reduction orders differ); against the reference's
  dp=1 step on the same global batch 1e-5 for the losses and 1e-4 for
  the params after the steps.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import _torch_train_worker as train_worker  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.planservice import PlanService as RefPlanService  # noqa: E402
from repro.data.pipeline import _batch_for_step as ref_batch_for_step  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jflash_ref  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.attention import blockwise_attention  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.topology import ring as ref_ring  # noqa: E402

from repro_torch.bridge import named_leaves, params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import PlanService  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataPipeline,
    _batch_for_step,
    shard_batch,
)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.topology import ring  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LM_TOL, LOSS_TOL = 1e-4, 1e-5
ADAMW_TOL = 1e-6
CONFORMANCE_TOL = 1e-6

# tests/test_kernels.py:23-70: B, S, H, KV, hd, dtype, mask
BWD_CASES = [
    *[(*shape, "float32", dict(causal=causal))
      for shape in ((1, 128, 4, 4, 32), (2, 128, 4, 2, 32), (1, 256, 8, 1, 16),
                    (1, 192, 2, 2, 64))
      for causal in (True, False)],
    *[(1, 256, 4, 4, 32, "float32", dict(causal=True, window=w)) for w in (32, 96)],
    (1, 128, 2, 2, 32, "float32", dict(causal=True, softcap=20.0)),
    (1, 128, 4, 2, 32, "bfloat16", dict(causal=True)),
]


def _case_id(case):
    B, S, H, KV, hd, dt, kw = case
    return f"{B}x{S}x{H}x{KV}x{hd}-{dt}-" + "-".join(f"{k}{v}" for k, v in kw.items())


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, do


def _port_bwd(q, k, v, do, dt, kw):
    tq, tk, tv, tdo = (torch.from_numpy(x).to(getattr(torch, dt)) for x in (q, k, v, do))
    o = flash_attention_ref(tq, tk, tv, **kw)
    return [g.float().numpy() for g in flash_attention_bwd_ref(tq, tk, tv, o, tdo, **kw)]


def _jax_vjp(fn, q, k, v, do, dt):
    jdt = jnp.dtype(dt)
    grads = jax.jit(lambda a, b, c, d: jax.vjp(fn, a, b, c)[1](d))(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v, do)))
    return [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
def test_plain_backward_matches_jax_grad_of_ref(case):
    """The plain backward (the kernel's oracle on the card) against the
    autodiff of the JAX package's dense oracle."""
    B, S, H, KV, hd, dt, kw = case
    q, k, v, do = _inputs(0, B, S, H, KV, hd)
    want = _jax_vjp(lambda a, b, c: jflash_ref(a, b, c, **kw), q, k, v, do, dt)
    for name, got, w in zip(("dq", "dk", "dv"), _port_bwd(q, k, v, do, dt, kw), want):
        np.testing.assert_allclose(got, w, rtol=TOL[dt], atol=TOL[dt], err_msg=name)


# every case at the reference's test blocks (64, 64); the causal f32 cases
# also at two other block shapes: the result does not depend on the tiling
BLOCKWISE_CASES = [(case, (64, 64)) for case in BWD_CASES] + [
    (case, blocks) for case in BWD_CASES if case[5:] == ("float32", dict(causal=True))
    for blocks in ((64, 128), (128, 64))]


@pytest.mark.parametrize("case,blocks", BLOCKWISE_CASES,
                         ids=[f"{_case_id(c)}-blocks{b[0]}x{b[1]}" for c, b in BLOCKWISE_CASES])
def test_plain_backward_matches_flash_bwd_vjp(case, blocks):
    """Against the reference's blockwise custom VJP (``_flash_bwd_vjp``)."""
    B, S, H, KV, hd, dt, kw = case
    q, k, v, do = _inputs(1, B, S, H, KV, hd)
    fn = lambda a, b, c: blockwise_attention(a, b, c, block_q=blocks[0],  # noqa: E731
                                             block_kv=blocks[1], **kw)
    want = _jax_vjp(fn, q, k, v, do, dt)
    for name, got, w in zip(("dq", "dk", "dv"), _port_bwd(q, k, v, do, dt, kw), want):
        np.testing.assert_allclose(got, w, rtol=TOL[dt], atol=TOL[dt], err_msg=name)


def test_backward_dispatch_and_head_dims():
    """A CPU tensor takes the plain backward; other devices raise; the
    kernel's wrapper refuses a head_dim it is not built for, naming the
    range, whatever the device."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 1, 16, 2, 1, 8))
    o = flash_attention_ref(q, k, v)
    got = ops.flash_attention_bwd(q, k, v, o, do)
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, o, do)):
        assert torch.equal(g, w)
    meta = [t.to("meta") for t in (q, k, v, o, do)]
    with pytest.raises(ValueError, match="no flash_attention_bwd for device"):
        ops.flash_attention_bwd(*meta)
    with pytest.raises(ValueError, match="must be shaped as q"):
        ops.flash_attention_bwd(q, k, v, o[:, :8], do)
    wide = [torch.zeros((1, 8, 2, tfa.BWD_MAX_HEAD_DIM + 1)) for _ in range(5)]
    with pytest.raises(ValueError, match=f"head_dim 1..{tfa.BWD_MAX_HEAD_DIM}"):
        tfa.flash_attention_bwd(*wide)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_bwd(q, k, v, o, do)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=5, softcap=7.0),
                                dict(causal=False)])
def test_training_attention_grads_equal_autograd_of_plain(kw):
    """The autograd function (forward, then the backward of the saved
    output) against torch's autograd through the plain forward, GQA."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 2, 24, 4, 2, 8))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tattn.flash_attention_train(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = flash_attention_ref(*ref_leaves, **kw)
    want = torch.autograd.grad(ref_out, ref_leaves, do)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL["float32"], atol=TOL["float32"])


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, 2] = -1
    want = float(jl.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tl.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=LOSS_TOL)
    none = torch.full((2, 3), -1)
    assert float(tl.softmax_xent(torch.zeros((2, 3, 5)), none)) == 0.0


# reduced llama3.2-1b configs in f32: train_lm's tiny and 10m, and the
# reduced model with a sliding window shorter than the sequence, a softcap
# and partial rotary (the masks of the backward through the model)
LM_CASES = {
    "tiny": (train_lm.MODELS["tiny"], False),
    "tiny_remat": (train_lm.MODELS["tiny"], True),
    "10m": (train_lm.MODELS["10m"], True),
    "reduced_swa_softcap": (dict(num_layers=3, sliding_window=8, attn_logit_softcap=30.0,
                                 rotary_pct=0.5), True),
}


def _port_llama():
    from repro_torch.configs import get_config

    return get_config("llama3.2-1b")


def _jax_params(jcfg, seed=0):
    jparams = JLM(jcfg).init(jax.random.PRNGKey(seed))
    return jparams, jax.tree.map(np.asarray, jparams)


def _batch(seed, B, S, vocab):
    b = _batch_for_step(seed, 0, B, S, vocab)
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_loss_and_grads_match_jax(name):
    """``LM.loss`` and its gradients (the attention through the training
    autograd function) against ``jax.value_and_grad`` of the reference's
    ``LM.loss``, f32."""
    overrides, remat = LM_CASES[name]
    jcfg = jget_config("llama3.2-1b").reduced(**overrides, dtype="float32")
    tcfg = _port_llama().reduced(**overrides, dtype="float32")
    jparams, np_params = _jax_params(jcfg)
    jb, tb = _batch(5, 2, 40, jcfg.vocab_size)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(JLM(jcfg).loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in jb.items()})
    params = params_from_jax(np_params, device="cpu", dtype=torch.float32)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    loss, metrics = TLM(tcfg, device="cpu", remat=remat).loss(params, tb)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_TOL)
    assert float(metrics["xent"].detach()) == pytest.approx(float(jmetrics["xent"]), rel=LOSS_TOL)
    assert float(metrics["moe_aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [tuple(k.key for k in path) for path, _ in jleaves] == \
        [path for path, _ in named_leaves(params)]
    for (path, jg), g in zip(jleaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=LM_TOL, atol=LM_TOL,
                                   err_msg=str(path))


def test_bridge_round_trip_and_leaf_order():
    """params_to_numpy undoes params_from_jax leaf for leaf, and
    named_leaves walks a tree in jax's flattening order."""
    jcfg = jget_config("llama3.2-1b").reduced(dtype="float32")
    jparams, np_params = _jax_params(jcfg, seed=3)
    back = params_to_numpy(params_from_jax(np_params, device="cpu", dtype=torch.float32))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    names = [".".join(path) for path, _ in named_leaves(back)]
    assert names == [".".join(k.key for k in path)
                     for path, _ in jax.tree_util.tree_leaves_with_path(jparams)]


def _adamw_tree(rng):
    """Leaves of every kind the decay rule tells apart: 2-d and stacked 3-d
    weights, 1-d and stacked norm scales, and the SSM's exempt names."""
    shapes = {"embed": {"table": (16, 8)}, "final_ln": {"scale": (8,)},
              "layers": {"attn": {"wq": (2, 8, 8)}, "ln1": {"scale": (2, 8)}},
              "ssd": {"A_log": (4, 3), "D": (4,), "dt_bias": (4, 3), "norm_scale": (3, 4),
                      "w_in": (3, 5)}}

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return rng.standard_normal(t).astype(np.float32)

    return draw(shapes), draw


@pytest.mark.parametrize("lr", ["cosine", 1e-2])
def test_adamw_steps_match_reference(lr):
    """Four steps from equal params and gradients (the gradients' norm above
    the clip in some steps, below it in others), against
    ``repro.optim.adamw_update``: params, moments, norm and rate."""
    rng = np.random.default_rng(6)
    params, draw = _adamw_tree(rng)
    jlr = jadamw.cosine_schedule(3e-2, warmup=2, total=10) if lr == "cosine" else lr
    tlr = tadamw.cosine_schedule(3e-2, warmup=2, total=10) if lr == "cosine" else lr
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.adamw_init(jp)
    jupdate = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, lr=jlr))
    # the port updates its params in place; its own copies, since jnp.asarray
    # of a numpy array on the CPU may share that array's memory
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    tstate = tadamw.adamw_init(tp)
    for scale in (3.0, 0.01, 1.0, 0.05):
        grads = jax.tree.map(lambda g: g * np.float32(scale), draw(jax.tree.map(np.shape, params)))
        jp, jstate, jm = jupdate(jp, jax.tree.map(jnp.asarray, grads), jstate)
        tp, tstate, tm = tadamw.adamw_update(tp, jax.tree.map(torch.from_numpy, grads), tstate,
                                             lr=tlr)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=ADAMW_TOL)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=ADAMW_TOL)
        for want, got in ((jp, tp), (jstate.mu, tstate.mu), (jstate.nu, tstate.nu)):
            for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=ADAMW_TOL,
                                           atol=ADAMW_TOL)
    assert tstate.step == int(jstate.step) == 4


def test_cosine_schedule_and_clip_match_reference():
    jlr, tlr = jadamw.cosine_schedule(3e-4, 20, 100), tadamw.cosine_schedule(3e-4, 20, 100)
    for step in (0, 1, 7, 19, 20, 21, 60, 99, 100, 150):
        assert float(tlr(step)) == float(jlr(jnp.asarray(step, jnp.int32)))
    rng = np.random.default_rng(7)
    grads, _ = _adamw_tree(rng)
    for max_norm in (0.5, 100.0):
        jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
        tg, tn = tadamw.clip_by_global_norm(jax.tree.map(torch.from_numpy, grads), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=ADAMW_TOL)
        for w, g in zip(jax.tree.leaves(jg), jax.tree.leaves(tg)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=ADAMW_TOL, atol=ADAMW_TOL)


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (1234, 0, 8, 256, 512), (1234, 17, 8, 32, 8192), (0, 3, 4, 1024, 128256), (7, 1, 3, 5, 2)])
def test_batch_for_step_equal_bit_for_bit(seed, step, batch, seq, vocab):
    want = ref_batch_for_step(seed, step, batch, seq, vocab)
    got = _batch_for_step(seed, step, batch, seq, vocab)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_data_pipeline_restarts_and_shards():
    """The pipeline yields ``_batch_for_step`` as int64 tensors, restarts
    exactly at ``start_step``, and the ranks' shards tile the batch."""
    pipe = DataPipeline(seed=1234, batch=8, seq=16, vocab=512)
    first = [next(pipe) for _ in range(4)]
    pipe.close()
    for step, batch in first:
        want = _batch_for_step(1234, step, 8, 16, 512)
        assert batch["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(batch["tokens"].numpy(), want["tokens"])
        np.testing.assert_array_equal(batch["labels"].numpy(), want["labels"])
    assert [step for step, _ in first] == [0, 1, 2, 3]
    restarted = DataPipeline(seed=1234, batch=8, seq=16, vocab=512, start_step=2)
    step, batch = next(restarted)
    restarted.close()
    assert step == 2 and torch.equal(batch["tokens"], first[2][1]["tokens"])
    shards = [shard_batch(first[0][1], r, 4) for r in range(4)]
    assert torch.equal(torch.cat([s["tokens"] for s in shards]), first[0][1]["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(first[0][1], 0, 3)


@pytest.mark.parametrize("n", [4, 8])
def test_plan_service_program_equals_reference(n):
    """``PlanService.program()`` for the DP all-reduce over a bidirectional
    ring: the reference's rounds, sends, digest and buffer plan."""
    ref_prog, ref_plan = RefPlanService().program(ref_ring(n, bidirectional=True),
                                                  {"data": n}, "all_reduce", "data")
    svc = PlanService()
    prog, plan = svc.program(ring(n, bidirectional=True), {"data": n}, "all_reduce", "data")
    assert (prog.num_rounds, prog.num_sends) == (ref_prog.num_rounds, ref_prog.num_sends)
    assert prog.digest() == ref_prog.digest()
    assert plan.buffer_slots == ref_plan.buffer_slots
    assert plan.num_devices == ref_plan.num_devices == n
    assert svc.metrics()["planners"] == 1
    # the repair entry is copied: it returns the service's repairer of the
    # ring, which repairs a failed link of the DP all-reduce
    from repro_torch.core import CollectiveRequest, DegradationEvent, PlanRepairer

    fabric = ring(n, bidirectional=True)
    repairer = svc.repairer(fabric)
    assert isinstance(repairer, PlanRepairer) and svc.repairer(fabric) is repairer
    res = repairer.repair(CollectiveRequest("all_reduce", group=tuple(range(n))),
                          DegradationEvent(failed_links=[0]))
    res.algorithm.validate()
    assert 0 not in res.view.links


def _f32_tiny():
    return dataclasses.replace(train_lm.model_config("tiny"), dtype="float32")


def test_train_lm_dp8_stacked_pccl_conforms_to_builtin():
    """tiny at dp=8, all ranks in this process: the PCCL and built-in runs
    agree within 1e-6 (their reduction orders differ), every rank's params
    stay equal bit for bit, and the conformance line is printed."""
    lines = []
    out = train_lm.train(_f32_tiny(), steps=2, batch=8, seq=32, dp=8, compare=True,
                         device="cpu", log=lines.append)
    assert out["max_loss_diff"] <= CONFORMANCE_TOL
    assert out["max_param_diff"] <= CONFORMANCE_TOL
    for name in train_lm.COLLECTIVES:
        trainer = out[name]["trainer"]
        assert len(trainer.replicas) == 8 and trainer.replicas_equal()
        assert all(np.isfinite(out[name]["loss"])) and len(out[name]["loss"]) == 2
    assert lines[-1].startswith("PCCL_CONFORMANCE max_loss_diff=")


def test_train_lm_loss_trajectory_matches_reference_dp1():
    """The dp=8 PCCL step against the reference's dp=1 step on the same
    global batches from the same (JAX-initialised) params, f32: AdamW over
    the mean of 8 shards' gradients is AdamW over the global gradient."""
    cfg = _f32_tiny()
    jcfg = jget_config("llama3.2-1b").reduced(**train_lm.MODELS["tiny"], dtype="float32")
    jparams, np_params = _jax_params(jcfg, seed=1)
    steps, batch, seq = 3, 8, 32
    lr = jadamw.cosine_schedule(3e-4, warmup=20, total=max(steps, 100))
    jlm = JLM(jcfg)

    @jax.jit
    def ref_step(params, opt, b):
        (loss, _), grads = jax.value_and_grad(jlm.loss, has_aux=True)(params, b)
        params, opt, _ = jadamw.adamw_update(params, grads, opt, lr=lr)
        return params, opt, loss

    opt, ref_losses = jadamw.adamw_init(jparams), []
    for step in range(steps):
        b = ref_batch_for_step(train_lm.DATA_SEED, step, batch, seq, jcfg.vocab_size)
        jparams, opt, loss = ref_step(jparams, opt, {k: jnp.asarray(v) for k, v in b.items()})
        ref_losses.append(float(loss))
    out = train_lm.train(cfg, steps=steps, batch=batch, seq=seq, dp=8, device="cpu",
                         params=params_from_jax(np_params, device="cpu", dtype=torch.float32),
                         log=lambda line: None)
    np.testing.assert_allclose(out["pccl"]["loss"], ref_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    got = params_to_numpy(out["pccl"]["trainer"].replicas[0])
    for w, g in zip(jax.tree.leaves(jparams), jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=LM_TOL, atol=LM_TOL)


def test_train_lm_gloo_8_ranks_through_dist_backend(tmp_path):
    """Eight gloo ranks, one process each (spawned; no jax in them), train
    tiny through ``DistBackend`` and ``dist.all_reduce`` side by side: the
    ranks' params are equal bit for bit, PCCL conforms to the built-in
    reduction within 1e-6, and both match the stacked run in this process.
    Fails, and stops its processes, after 150 s rather than hang."""
    import torch.multiprocessing as mp

    world = 8
    ctx = mp.start_processes(train_worker.run_rank, nprocs=world, join=False,
                             args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
                             start_method="spawn")
    deadline = time.monotonic() + 150
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks did not finish in 150 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    stacked = train_lm.train(train_worker.config(), steps=train_worker.STEPS,
                             batch=train_worker.BATCH, seq=train_worker.SEQ, dp=world,
                             compare=True, device="cpu", params=train_worker.initial_params(),
                             log=lambda line: None)
    for name in train_lm.COLLECTIVES:
        losses = np.stack([np.load(tmp_path / f"{name}.loss.{r}.npy") for r in range(world)])
        params = np.stack([np.load(tmp_path / f"{name}.params.{r}.npy") for r in range(world)])
        assert (losses == losses[0]).all(), f"{name}: the ranks' losses differ"
        assert (params.view(np.uint32) == params[0].view(np.uint32)).all(), \
            f"{name}: the ranks' params differ"
        np.testing.assert_allclose(losses[0], stacked[name]["loss"], rtol=CONFORMANCE_TOL,
                                   atol=CONFORMANCE_TOL)
        np.testing.assert_allclose(params[0], train_worker.flat_params(stacked[name]["trainer"]),
                                   rtol=CONFORMANCE_TOL, atol=CONFORMANCE_TOL)
    log = (tmp_path / "log.0.txt").read_text().splitlines()
    conformance = dict(kv.split("=") for kv in log[-1].split()[1:])
    assert float(conformance["max_loss_diff"]) <= CONFORMANCE_TOL
    assert float(conformance["max_param_diff"]) <= CONFORMANCE_TOL


def test_train_lm_main_needs_cuda_unless_cpu(monkeypatch, capsys):
    """The entry point runs on the card unless asked for the CPU; on the
    CPU it prints the conformance line of the bf16 tiny model."""
    assert train_lm.main(["--model", "tiny", "--dp", "8", "--compare-collectives",
                          "--device", "cpu", "--steps", "1", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "PCCL_CONFORMANCE max_loss_diff=" in out and "done: 1 steps" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--model", "tiny", "--steps", "1"])
    with pytest.raises(ValueError, match="not divisible"):
        train_lm.train(_f32_tiny(), steps=1, batch=6, seq=8, dp=4, device="cpu")


def test_train_lm_dp1_default_flags(capsys):
    """dp=1 under the default flags (``--collectives builtin``) takes a plain
    step with no collective, as the reference does: no ring, no plan, the
    gradient as it is. ``--compare-collectives`` at dp=1 still raises."""
    assert train_lm.main(["--model", "tiny", "--steps", "2", "--batch", "2",
                          "--seq", "32", "--device", "cpu"]) == 0
    assert "done: 2 steps" in capsys.readouterr().out
    mean = train_lm.GradientMean(1, "pccl")
    assert not hasattr(mean, "program") and not hasattr(mean, "topo")
    vec = torch.arange(5, dtype=torch.float32)[None]
    assert mean(vec) is vec
    with pytest.raises(ValueError, match="needs --dp > 1"):
        train_lm.main(["--model", "tiny", "--steps", "1", "--batch", "2", "--seq", "16",
                       "--device", "cpu", "--compare-collectives"])


def test_train_lm_defaults_to_the_builtin_reduction(monkeypatch):
    """``--collectives`` defaults to ``builtin``, the framework's reduction,
    as the reference's ``examples/train_lm.py`` defaults to its own: at
    ``--dp 2`` with no ``--collectives`` the step runs ``x.sum(0)``, not a
    synthesized plan."""
    runs = []
    real_train = train_lm.train
    monkeypatch.setattr(train_lm, "train", lambda *a, **kw: runs.append(real_train(*a, **kw)))
    assert train_lm.main(["--model", "tiny", "--dp", "2", "--steps", "1", "--batch", "2",
                          "--seq", "16", "--device", "cpu"]) == 0
    (out,) = runs
    assert set(out) == {"builtin"}
    mean = out["builtin"]["trainer"].mean
    assert mean.collectives == "builtin" and not hasattr(mean, "program")
