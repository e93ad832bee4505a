"""The port's checkpointer, fault-tolerance runtime, data pieces and
checkpoint/resume in ``train_lm`` against the reference, on the CPU.

* The reference's checkpointer cases on torch tensors: the atomic round
  trip, pruning, ``.tmp`` never visible, and the kill-and-restore loop on
  the port's LM (bit-equal replay).
* The on-disk layout is the reference's both ways: each package restores a
  checkpoint the other wrote, params and AdamW state, bit-equal.
* The two places where torch differs from jax: the snapshot copies (a
  write that waits until after an in-place step still saves the state
  before it), and a bf16 leaf comes back as bf16, from either writer.
* The reference's runtime suites (``tests/test_substrate.py``'s
  ``TestFaultTolerance``, ``tests/test_repair.py``'s
  ``TestFaultToleranceWiring``) run on the copy through
  ``tests/_torch_ported.py``.
* ``chip_smoke.py``'s checkpoint phase at the tiny model, f32: its
  checkpoint/resume, and its elastic recovery (8 ranks to 7, the
  all-reduce repaired, losses within 1e-5 of the uninterrupted run; two
  dead NPUs split the ring and raise before any restore).
* ``train_lm``'s ``--ckpt-every`` / ``--resume`` in one process and on two
  spawned gloo ranks: a resumed run is the uninterrupted one bit for bit,
  and label k holds AdamW step k.
* Pins of two reference faults (ROADMAP §3): its ``train_lm``'s label k
  holds AdamW step k + 1, and its restore returns a bf16 leaf as ``V2``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_checkpoint.py
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_train_worker as train_worker
from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_ported import against_the_copy

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as jget_config
from repro.data import pipeline as ref_pipeline
from repro.models import LM as JLM
from repro.optim import adamw as jadamw

from repro_torch.bridge import named_leaves, params_from_jax, params_to_numpy
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, synthetic_lm_batches
from repro_torch.data.pipeline import _batch_for_step
from repro_torch.launch import train_lm
from repro_torch.models import LM
from repro_torch.optim import AdamWState, adamw_init, adamw_update

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ELASTIC_TOL = 1e-5  # a resumed dp = 7 loss against the uninterrupted dp = 8 one

# the reference's runtime suites, bound to the copy
TestFaultTolerance = against_the_copy("test_substrate.py",
                                      only=("TestFaultTolerance",))["TestFaultTolerance"]
TestFaultToleranceWiring = against_the_copy(
    "test_repair.py", only=("_internal_link", "_FakeCheckpointer",
                            "TestFaultToleranceWiring"))["TestFaultToleranceWiring"]


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as unsigned integers of its width."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(f"u{t.element_size()}")


def _assert_trees_equal(got, want):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(_bits(got[path]), _bits(want[path]), err_msg=str(path))


def _tiny_lm():
    cfg = get_config("llama3.2-1b").reduced(num_layers=1, vocab_size=128, dtype="float32")
    return cfg, LM(cfg, device="cpu")


def _step(lm, params, opt, batch):
    loss, grads = train_lm.loss_and_grads(lm, params, batch)
    adamw_update(params, grads, opt, lr=1e-3)
    return float(loss)


def _batch(step, vocab):
    return {k: torch.from_numpy(v).long()
            for k, v in _batch_for_step(11, step, 2, 16, vocab).items()}


def _trainable(params):
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# the reference's checkpointer cases, on torch tensors
# ---------------------------------------------------------------------------

def test_atomic_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step_meta": {"data_step": torch.tensor(5)}}
    ck.save(5, state).result()
    assert ck.latest_step() == 5
    step, restored = ck.restore(state)
    assert step == 5
    _assert_trees_equal(restored, state)
    ck.close()


def test_prune_keeps_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"params": {"w": torch.zeros(2)}}).result()
    ck.wait()
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == [3, 4]
    ck.close()


def test_no_partial_checkpoint_visible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"params": {}})
    ck.close()


def test_kill_and_restore_training(tmp_path):
    """Train 4 steps saving at 2, 'crash', restore and replay steps 2-3:
    the losses and the params are the uninterrupted run's bit for bit."""
    cfg, lm = _tiny_lm()
    params = _trainable(lm.init(0, param_dtype=torch.float32))
    opt = adamw_init(params)
    ck = Checkpointer(str(tmp_path))
    losses = []
    for step in range(4):
        if step == 2:
            ck.save(2, {"params": params, "opt": opt}).result()
        losses.append(_step(lm, params, opt, _batch(step, cfg.vocab_size)))
    step0, restored = ck.restore({"params": params, "opt": opt})
    assert step0 == 2 and restored["opt"].step == 2
    p2, o2 = _trainable(restored["params"]), restored["opt"]
    replay = [_step(lm, p2, o2, _batch(step, cfg.vocab_size)) for step in range(2, 4)]
    assert replay == losses[2:]
    _assert_trees_equal(p2, params)
    _assert_trees_equal(o2.mu, opt.mu)
    ck.close()


# ---------------------------------------------------------------------------
# the layout: each package restores the other's checkpoints
# ---------------------------------------------------------------------------

def _jax_state():
    """The reference's params (JAX init, f32) and an AdamW state whose
    moments are not zero."""
    jcfg = jget_config("llama3.2-1b").reduced(num_layers=1, vocab_size=128, dtype="float32")
    jparams = JLM(jcfg).init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    moment = lambda: jax.tree.map(  # noqa: E731
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), jparams)
    return jparams, jadamw.AdamWState(jnp.asarray(3, jnp.int32), moment(), moment())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_port_restores_the_references_checkpoint(tmp_path):
    jparams, jopt = _jax_state()
    ref = RefCheckpointer(str(tmp_path))
    ref.save(3, {"params": jparams, "opt": jopt}).result()
    ref.close()
    params = params_from_jax(_np(jparams), device="cpu", dtype=torch.float32)
    step, got = Checkpointer(str(tmp_path)).restore({"params": params,
                                                     "opt": adamw_init(params)})
    assert step == 3 and got["opt"].step == 3
    _assert_trees_equal(got["params"], params)
    for name in ("mu", "nu"):
        _assert_trees_equal(getattr(got["opt"], name), params_from_jax(
            _np(getattr(jopt, name)), device="cpu", dtype=torch.float32))


def test_reference_restores_the_ports_checkpoint(tmp_path):
    jparams, jopt = _jax_state()
    cfg, lm = _tiny_lm()
    params = lm.init(5, param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(6)
    opt = AdamWState(5, *[train_lm._tree_like(params, (
        torch.randn(t.shape, generator=gen) for _, t in named_leaves(params)))
        for _ in range(2)])
    Checkpointer(str(tmp_path)).save(5, {"params": params, "opt": opt}).result()
    step, got = RefCheckpointer(str(tmp_path)).restore({"params": jparams, "opt": jopt})
    assert step == 5
    assert got["opt"].step.dtype == np.int32 and got["opt"].step == 5
    for mine, theirs in ((params, got["params"]), (opt.mu, got["opt"].mu),
                         (opt.nu, got["opt"].nu)):
        want = params_to_numpy(mine)
        assert jax.tree.structure(theirs) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(want)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


# ---------------------------------------------------------------------------
# trap 1, the snapshot; trap 2, bf16
# ---------------------------------------------------------------------------

def test_snapshot_is_taken_before_save_returns(tmp_path, monkeypatch):
    """The write is held until after an in-place AdamW step: the checkpoint
    still holds the state before the step."""
    cfg, lm = _tiny_lm()
    params = _trainable(lm.init(0, param_dtype=torch.float32))
    opt = adamw_init(params)
    _step(lm, params, opt, _batch(0, cfg.vocab_size))
    before = {"params": train_lm.clone_params(params), "opt": train_lm.clone_opt(opt)}
    gate, write = threading.Event(), Checkpointer._write

    def held_write(self, *args):
        assert gate.wait(30)
        return write(self, *args)

    monkeypatch.setattr(Checkpointer, "_write", held_write)
    ck = Checkpointer(str(tmp_path))
    fut = ck.save(1, {"params": params, "opt": opt})
    _step(lm, params, opt, _batch(1, cfg.vocab_size))
    gate.set()
    fut.result(timeout=30)
    step, got = ck.restore({"params": params, "opt": opt})
    ck.close()
    assert step == 1 and got["opt"].step == 1 and opt.step == 2
    _assert_trees_equal(got["params"], before["params"])
    _assert_trees_equal(got["opt"].mu, before["opt"].mu)
    _assert_trees_equal(got["opt"].nu, before["opt"].nu)


def test_bf16_round_trips_as_bf16(tmp_path):
    gen = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn((3, 5), generator=gen).bfloat16(),
                        "norm": {"scale": torch.randn(5, generator=gen)}}}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state).result()
    with np.load(tmp_path / "step_00000001" / "params.npz") as data:
        assert data["w"].dtype == np.dtype("V2") and data["norm/scale"].dtype == np.float32
    _, got = ck.restore(state)
    _assert_trees_equal(got, state)
    ck.close()


def test_reference_bf16_leaf_restores_as_bf16(tmp_path):
    w = jnp.asarray(np.random.default_rng(1).standard_normal((4, 6)), jnp.bfloat16)
    RefCheckpointer(str(tmp_path)).save(2, {"params": {"w": w}}).result()
    _, got = Checkpointer(str(tmp_path)).restore(
        {"params": {"w": torch.zeros((4, 6), dtype=torch.bfloat16)}})
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["params"]["w"]), np.asarray(w).view(np.uint16))


def test_restore_places_leaves_on_the_named_devices(tmp_path):
    """``shardings`` names a device for a whole tree or a tree of devices;
    a tree it does not name keeps its template's device."""
    state = {"params": {"a": torch.ones(2), "b": {"c": torch.zeros(3)}},
             "opt": AdamWState(4, {"a": torch.ones(2)}, {"a": torch.ones(2)})}
    ck = Checkpointer(str(tmp_path))
    ck.save(4, state).result()
    cpu = torch.device("cpu")
    for shardings in ({"params": cpu, "opt": "cpu"},
                      {"params": {"a": cpu, "b": {"c": cpu}}}, {}, None):
        _, got = ck.restore(state, shardings=shardings)
        _assert_trees_equal(got["params"], state["params"])
        assert got["opt"].step == 4
    ck.close()


# ---------------------------------------------------------------------------
# chip_smoke.py's checkpoint phase at the tiny model
# ---------------------------------------------------------------------------

def _f32_tiny():
    return dataclasses.replace(train_lm.model_config("tiny"), dtype="float32")


def test_chip_smoke_checkpoint_resume_tiny(tmp_path):
    got = chip_smoke.checkpoint_resume(torch, torch.device("cpu"), _f32_tiny(), 2, 16,
                                       str(tmp_path))
    assert got["losses_bit_equal"] and got["params_bit_equal"]
    assert got["restored"]["step"] == got["restored"]["opt_step"] == chip_smoke.CKPT_LABEL
    assert got["save"]["step"] == chip_smoke.CKPT_LABEL and got["bytes"] > 0
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]  # R wrote nothing


def test_chip_smoke_elastic_recovery_tiny(tmp_path):
    """8 ranks stacked lose NPU 7: the all-reduce is repaired for the 7
    survivors, label 2 restored, and a dp = 7 run resumes within 1e-5 of
    the uninterrupted dp = 8 run. NPUs 3 and 7 split the ring: the
    recovery raises before any restore (checked inside)."""
    got = chip_smoke.elastic_recovery(torch, torch.device("cpu"), _f32_tiny(),
                                      chip_smoke.ELASTIC_BATCH, 16, str(tmp_path))
    assert got["max_loss_diff"] <= ELASTIC_TOL and got["max_param_diff"] <= ELASTIC_TOL
    assert tuple(got["res"].request.group) == tuple(range(7))
    assert "strongly connected components" in got["refused"]
    assert len(got["r7"]["trainer"].replicas) == 7 and got["r7"]["trainer"].replicas_equal()


# ---------------------------------------------------------------------------
# train_lm: --ckpt-every and --resume
# ---------------------------------------------------------------------------

def _main_runs(monkeypatch):
    runs = []
    real = train_lm.train
    monkeypatch.setattr(train_lm, "train", lambda *a, **kw: runs.append(real(*a, **kw))
                        or runs[-1])
    return runs


def _opt_step(ckpt_dir, label) -> np.ndarray:
    with np.load(Path(ckpt_dir) / f"step_{label:08d}" / "opt.npz") as data:
        return data[".step"]


def test_train_lm_resume_is_the_uninterrupted_run(tmp_path, monkeypatch, capsys):
    """``main`` with ``--ckpt-every 2`` stopped after 3 steps, then
    ``--resume`` to 4, gives the uninterrupted run's losses and params bit
    for bit; label k holds AdamW step k."""
    runs = _main_runs(monkeypatch)
    argv = ["--model", "tiny", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-every", "2"]
    assert train_lm.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "u")]) == 0
    assert train_lm.main([*argv, "--steps", "3", "--ckpt-dir", str(tmp_path / "c")]) == 0
    assert _opt_step(tmp_path / "c", 2) == 2
    assert train_lm.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "c"),
                          "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out and "done: 2 steps" in out
    u, c, r = (run["builtin"] for run in runs)
    assert r["start_step"] == 2 and r["restored"]["opt_step"] == 2
    assert c["loss"] == u["loss"][:3] and r["loss"] == u["loss"][2:]
    _assert_trees_equal(r["trainer"].replicas[0], u["trainer"].replicas[0])
    assert r["trainer"].opts[0].step == u["trainer"].opts[0].step == 4
    for d, labels in (("u", (2, 4)), ("c", (2, 4))):
        for label in labels:
            assert _opt_step(tmp_path / d, label) == label
    assert [s["step"] for s in u["saves"]] == [2, 4]
    assert all(s["write_s"] >= 0 and s["save_s"] >= 0 for s in u["saves"])


def test_train_lm_resume_without_a_checkpoint_starts_at_0(tmp_path):
    out = train_lm.train(_f32_tiny(), steps=1, batch=2, seq=16, device="cpu",
                         ckpt_dir=str(tmp_path), resume=True, log=lambda line: None)["pccl"]
    assert out["start_step"] == 0 and out["restored"] is None and out["saves"] == []
    with pytest.raises(ValueError, match="takes no checkpoints"):
        train_lm.train(_f32_tiny(), steps=1, batch=2, seq=16, dp=2, compare=True,
                       device="cpu", ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="needs a checkpoint directory"):
        train_lm.train(_f32_tiny(), steps=1, batch=2, seq=16, device="cpu", resume=True)


def test_trainer_replicas_copy_the_restored_state():
    """Each stacked replica gets its own copy of the given params and AdamW
    state: one replica's in-place update leaves the others' alone."""
    cfg = _f32_tiny()
    lm = LM(cfg, device="cpu")
    params = lm.init(0, param_dtype=torch.float32)
    opt = AdamWState(7, train_lm.clone_params(params), train_lm.clone_params(params))
    trainer = train_lm.Trainer(lm, params, 2, "builtin", 1e-3, opt=opt)
    assert trainer.replicas_equal() and [o.step for o in trainer.opts] == [7, 7]
    first = named_leaves(trainer.opts[0].mu)[0][1]
    first.add_(1.0)
    assert not torch.equal(first, named_leaves(trainer.opts[1].mu)[0][1])
    assert not torch.equal(first, named_leaves(opt.mu)[0][1])


def test_train_lm_gloo_2_ranks_resume(tmp_path):
    """Two gloo ranks (spawned, no jax): rank 0 alone writes, both restore,
    and the resumed run is the uninterrupted one bit for bit on each rank."""
    import torch.multiprocessing as mp

    world = 2
    ctx = mp.start_processes(train_worker.run_ckpt_rank, nprocs=world, join=False,
                             args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
                             start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks did not finish in 120 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for rank in range(world):
        got = np.load(tmp_path / f"ckpt.{rank}.npz")
        assert (got["resumed"] == got["uninterrupted"][2:]).all()
        assert (got["stopped"] == got["uninterrupted"][:3]).all()
        assert (got["params_r"].view(np.uint32) == got["params_u"].view(np.uint32)).all()
        assert list(got["saves"]) == ([2] if rank == 0 else [])
        assert int(got["restored"]) == 2
    assert _opt_step(tmp_path / "c", 2) == 2


# ---------------------------------------------------------------------------
# the data pieces
# ---------------------------------------------------------------------------

def test_synthetic_lm_batches_equal_the_references():
    ours, theirs = synthetic_lm_batches(9, 3, 8, 50), ref_pipeline.synthetic_lm_batches(9, 3, 8, 50)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_pipeline_step_counter_advances_as_the_references():
    ours = DataPipeline(seed=1, batch=2, seq=8, vocab=64, start_step=3)
    theirs = ref_pipeline.DataPipeline(seed=1, batch=2, seq=8, vocab=64, start_step=3)
    try:
        assert ours._step == theirs._step == 3
        for want in (4, 5):
            (s, b), (t, c) = next(ours), next(theirs)
            assert s == t and ours._step == theirs._step == want
            np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(c["tokens"]))
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------------------
# pins of the reference's faults (ROADMAP §3); each goes when the reference
# is fixed
# ---------------------------------------------------------------------------

def test_reference_train_lm_label_k_holds_step_k_plus_1_pinned(tmp_path):
    """ROADMAP §3, "the reference's resume applies one batch twice":
    examples/train_lm.py saves the state after step k's update under label
    k, so label 2 holds AdamW step 3 (the port's holds 2)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(ROOT / "examples" / "train_lm.py"), "--model", "tiny",
                    "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                    "--ckpt-dir", str(tmp_path)], env=env, check=True, timeout=120,
                   capture_output=True)
    assert _opt_step(tmp_path, 2) == 3


def test_reference_restores_bf16_as_raw_words_pinned(tmp_path):
    """ROADMAP §3, "the reference restores a bf16 leaf as raw words": its
    restore returns the ``V2`` array that numpy stored (the port's comes
    back as bf16)."""
    w = jnp.ones((2, 3), jnp.bfloat16)
    ck = RefCheckpointer(str(tmp_path))
    ck.save(1, {"params": {"w": w}}).result()
    _, got = ck.restore({"params": {"w": w}})
    ck.close()
    assert got["params"]["w"].dtype == np.dtype("V2")
