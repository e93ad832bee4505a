"""The port's launchers, ``launch/train.py`` and ``launch/serve.py``'s mesh
and policy, against the reference's, on the CPU.

* The reference's run: ``repro.launch.train --reduced --steps 12`` in f32,
  in a subprocess with an environment of its own (``PYTHONPATH=src``,
  ``JAX_PLATFORMS=cpu``, no ``XLA_FLAGS``: a test that sets a device count
  there would widen its mesh and pad its heads), each step's loss and
  gradient norm recorded by ``tests/_torch_launch_worker.py``; the port's
  ``train`` from the same params on a one-rank gloo group: every loss
  within rel 1e-4, every gradient norm within 1e-3.
* Resume: the port's ``--steps 12`` then ``--steps 14 --resume`` is the
  uninterrupted ``--steps 14`` bit for bit (both: warm-up 1, total 100).
* The pin (ROADMAP §3): the reference's label 10 holds AdamW step 11 and
  its resume starts at batch 10, applying it twice; the port's label 11
  holds step 11.
* Elastic: a checkpoint saved at one rank resumes on two spawned gloo
  ranks (mesh 1 x 2) to the next save, which resumes at one rank again;
  every loss within 1e-4 of the uninterrupted one-rank run.
* Serving: ``serve.main`` under the mesh and policy equals ``serve()`` on
  a plain ``LM``, tokens and logits.
* ``chip_smoke.py``'s ``launch`` phase rehearsed: a gloo group, a reduced
  config, the flash launches counted on a stand-in kernel module, the
  planted fault caught.
* The launch group: an existing group is used and kept, one started from
  torchrun's environment or through a file rendezvous is ended.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_launch.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from _torch_cpu import one_torch_thread  # noqa: E402, F401
import _torch_launch_worker as worker  # noqa: E402
from repro_torch.bridge import named_leaves, params_from_jax  # noqa: E402
from repro_torch.data.pipeline import stub_inputs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import launch_group  # noqa: E402
from repro_torch.models import LM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

LOSS_TOL = 1e-4
GNORM_TOL = 1e-3
ELASTIC_TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's two runs, started at the module's first test so that
    they go on while the port's cases run; ``wait()`` returns their record,
    the first run's params and stdout, and the checkpoint directory."""
    where = tmp_path_factory.mktemp("reference")
    keep = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG", "LD_LIBRARY_PATH")
            if k in os.environ}
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_launch_worker.py"), str(where),
         str(where / "ckpt")], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**keep, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                        "PYTHONHASHSEED": "0"})
    done = {}

    def wait():
        if not done:
            out, err = proc.communicate(timeout=180)
            assert proc.returncode == 0, err[-3000:]
            with np.load(where / "init.npz") as f:
                init = worker.nested({k: f[k] for k in f.files})
            done.update(json.loads((where / "steps.json").read_text()), init=init,
                        stdout=out, ckpt=where / "ckpt")
        return done

    yield types.SimpleNamespace(wait=wait)
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _local(tree) -> dict:
    """A tree of one-rank DTensors as {path: local tensor}."""
    return {"/".join(p): t.to_local() for p, t in named_leaves(tree)}


def _opt_step(ckpt_dir, label) -> int:
    with np.load(Path(ckpt_dir) / f"step_{label:08d}" / "opt.npz") as data:
        return int(data[".step"])


def _runs(monkeypatch) -> list:
    """Every ``train`` that ``main`` runs, its result recorded."""
    runs = []
    real = ttrain.train
    monkeypatch.setattr(ttrain, "train", lambda *a, **kw: runs.append(real(*a, **kw))
                        or runs[-1])
    return runs


def _quiet(line: str) -> None:
    pass


# ---------------------------------------------------------------------------
# the launch group
# ---------------------------------------------------------------------------

def test_launch_group_starts_and_ends_only_its_own(tmp_path):
    assert not dist.is_initialized()
    with launch_group("cpu") as (mesh, dev):
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (mesh.axis_names, mesh.shape, mesh.device_type) == (("data", "model"), (1, 1),
                                                                    "cpu")
        assert dev == CPU
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        with launch_group("cpu") as (mesh, _):
            assert mesh.shape == (1, 1)
        assert dist.is_initialized()  # the caller's group stays
    finally:
        dist.destroy_process_group()


def test_launch_group_from_torchrun_environment(monkeypatch):
    """``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` (and torchrun's store
    address) start the group from the environment: gloo on the CPU."""
    for k, v in {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "0"}.items():
        monkeypatch.setenv(k, v)
    seen = []
    real = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.append(kw) or real(**kw))
    with launch_group("cpu") as (mesh, _):
        assert mesh.shape == (1, 1)
    assert not dist.is_initialized()
    assert seen == [{"init_method": "env://", "rank": 0, "world_size": 1, "backend": "gloo"}]


def test_launchers_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            with launch_group(device):
                pass
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.train(worker.reduced_f32(), ttrain.REDUCED_SHAPE, steps=1,
                         ckpt_dir=tempfile.gettempdir(), device=device)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# resume, label k holding k updates
# ---------------------------------------------------------------------------

def test_resume_is_the_uninterrupted_run(tmp_path, monkeypatch, capsys):
    """``--steps 12`` (label 11) then ``--steps 14 --resume`` is ``--steps
    14`` uninterrupted bit for bit: losses, gradient norms, params, AdamW
    state. Label 11 holds AdamW step 11."""
    runs = _runs(monkeypatch)
    argv = ["--reduced", "--device", "cpu"]
    c, u = str(tmp_path / "c"), str(tmp_path / "u")
    assert ttrain.main([*argv, "--steps", "12", "--ckpt-dir", c]) == 0
    assert ttrain.main([*argv, "--steps", "14", "--ckpt-dir", c, "--resume"]) == 0
    assert ttrain.main([*argv, "--steps", "14", "--ckpt-dir", u]) == 0
    first, resumed, whole = runs
    assert os.listdir(c) == ["step_00000011"] and os.listdir(u) == ["step_00000011"]
    assert _opt_step(c, 11) == 11
    assert resumed["start_step"] == 11 and len(resumed["loss"]) == 3
    assert first["loss"] == whole["loss"][:12]
    assert resumed["loss"] == whole["loss"][11:]
    assert resumed["grad_norm"] == whole["grad_norm"][11:]
    assert resumed["opt"].step == whole["opt"].step == 14
    for tree in ("params", "opt"):
        got, want = resumed[tree], whole[tree]
        if tree == "opt":
            got, want = {"mu": got.mu, "nu": got.nu}, {"mu": want.mu, "nu": want.nu}
        got, want = _local(got), _local(want)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=llama3.2-1b (0.4M params) mesh={'data': 1, 'model': 1}"
    assert "resumed at step 11" in out and out.count("done") == 3
    assert [line for line in out if line.startswith("step")][:4] == [
        f"step {s:4d} loss={first['loss'][s]:.4f} gnorm={first['grad_norm'][s]:.2f}"
        for s in (0, 5, 10, 11)]


def test_resume_without_a_checkpoint_starts_at_0(tmp_path):
    out = ttrain.train(worker.reduced_f32(), worker.elastic_shape(), steps=1,
                       ckpt_dir=str(tmp_path), resume=True, device="cpu", log=_quiet)
    assert out["start_step"] == 0 and len(out["loss"]) == 1 and os.listdir(tmp_path) == []


def test_checkpointer_saves_dtensors_whole_and_restores_onto_the_template(tmp_path):
    """A tree of DTensors is written as its plain tree is (the same npz
    keys and bits), and restores as DTensors on the template's mesh and
    placements."""
    from repro_torch.checkpoint import Checkpointer

    lm = LM(worker.reduced_f32(), device="cpu")
    plain = lm.init(0, param_dtype=torch.float32)
    with launch_group("cpu") as (mesh, _):
        from repro_torch.launch.sharding import ShardingPolicy

        placed = ShardingPolicy(mesh, lm.cfg).param_shardings(ttrain.clone_params(plain))
        for name, tree in (("plain", plain), ("placed", placed)):
            ck = Checkpointer(str(tmp_path / name))
            ck.save(3, {"params": tree})
            ck.close()
        template = ShardingPolicy(mesh, lm.cfg).param_shardings(
            LM(lm.cfg, device="cpu").init(1, param_dtype=torch.float32))
        label, got = Checkpointer(str(tmp_path / "placed")).restore({"params": template})
        want = dict(named_leaves(template))
        for path, t in named_leaves(got["params"]):
            assert t.placements == want[path].placements and t.device_mesh is mesh.device_mesh
        got = _local(got["params"])
    assert label == 3
    with np.load(tmp_path / "plain" / "step_00000003" / "params.npz") as a, \
            np.load(tmp_path / "placed" / "step_00000003" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    for path, t in named_leaves(plain):
        assert torch.equal(got["/".join(path)], t), path


# ---------------------------------------------------------------------------
# elastic: one rank -> two -> one
# ---------------------------------------------------------------------------

def test_elastic_resume_across_mesh_sizes(tmp_path):
    """The uninterrupted one-rank run to batch 23 saves labels 11 and 21;
    label 11 alone, copied, resumes on two gloo ranks (mesh 1 x 2, the
    heads split) up to their own save at label 21, which resumes at one
    rank to 23. Every loss within 1e-4 of the uninterrupted run's: the
    row-parallel sums add in another order on two ranks."""
    import torch.multiprocessing as mp

    cfg, shape = worker.reduced_f32(), worker.elastic_shape()
    two, total = worker.ELASTIC_STEPS
    whole = ttrain.train(cfg, shape, steps=total, ckpt_dir=str(tmp_path / "u"), device="cpu",
                         log=_quiet)
    assert sorted(os.listdir(tmp_path / "u")) == ["step_00000011", "step_00000021"]
    shutil.copytree(tmp_path / "u" / "step_00000011", tmp_path / "e" / "step_00000011")
    ctx = mp.start_processes(worker.run_elastic_rank, nprocs=2, join=False,
                             start_method="spawn",
                             args=(2, str(tmp_path / "rdv"), str(tmp_path / "e"),
                                   str(tmp_path / "two.npz")))
    deadline = time.monotonic() + 150
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the two gloo ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with np.load(tmp_path / "two.npz") as f:
        got_two, start, lines, mesh = f["loss"], int(f["start"]), list(f["lines"]), f["mesh"]
    assert tuple(mesh) == (1, 2) and start == 11 and "resumed at step 11" in lines
    assert _opt_step(tmp_path / "e", 21) == 21
    back = ttrain.train(cfg, shape, steps=total, ckpt_dir=str(tmp_path / "e"), resume=True,
                        device="cpu", log=_quiet)
    assert back["start_step"] == 21 and back["mesh"].shape == (1, 1)
    np.testing.assert_allclose(got_two, whole["loss"][11:two], rtol=ELASTIC_TOL)
    np.testing.assert_allclose(back["loss"], whole["loss"][21:], rtol=ELASTIC_TOL)


# ---------------------------------------------------------------------------
# serving under the mesh and policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b", "whisper-medium"])
def test_serve_main_under_the_policy_equals_plain_serve(arch, monkeypatch):
    caught = []
    real = tserve.serve
    monkeypatch.setattr(tserve, "serve", lambda lm, params, prompts, n, **stub: caught.append(
        (lm, prompts, stub, real(lm, params, prompts, n, **stub))) or caught[-1][-1])
    assert tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "3"]) == 0
    (lm, prompts, stub, got), = caught
    assert lm.policy is not None and lm.policy.mesh.shape == (1, 1)
    plain = LM(lm.cfg, device="cpu")
    assert stub.keys() == stub_inputs(lm.cfg, 2, 0).keys()
    want = real(plain, plain.init(0), prompts, 3, **stub)
    for k in ("tokens", "prefill_logits", "last_logits"):
        assert torch.equal(got[k].full_tensor(), want[k]), k
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# chip_smoke.py's launch phase, rehearsed
# ---------------------------------------------------------------------------

def _counter(name: str):
    def fn():
        pass
    fn.__name__, fn.launches = name, 0
    return fn


@pytest.fixture
def counted_kernels(monkeypatch):
    """A stand-in of the flash kernel module whose counters count the plain
    versions' calls (every forward as a ``wgmma`` launch, every backward on
    the route that ``BWD_ROUTES`` names for its inputs)."""
    fake = types.SimpleNamespace(bwd_route=tfa.bwd_route, **{n: _counter(n) for n in (
        "flash_attention", "flash_attention_wgmma", "flash_attention_mma",
        "flash_attention_wide", "flash_attention_bwd", "flash_attention_bwd_wgmma",
        "flash_attention_bwd_mma")})
    fwd, bwd = ops.flash_attention_ref, ops.flash_attention_bwd_ref

    def forward(*a, **kw):
        fake.flash_attention.launches += 1
        fake.flash_attention_wgmma.launches += 1
        return fwd(*a, **kw)

    def backward(q, *a, **kw):
        fake.flash_attention_bwd.launches += 1
        getattr(fake, f"flash_attention_bwd_{tfa.bwd_route(q.dtype, q.shape[-1])}").launches += 1
        return bwd(q, *a, **kw)

    monkeypatch.setattr(ops, "flash_attention_ref", forward)
    monkeypatch.setattr(ops, "flash_attention_bwd_ref", backward)
    return fake


def _gloo_group(tmp_path):
    def start(torch):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                                world_size=1)
        return dist.destroy_process_group
    return start


REHEARSAL = dict(cfg=worker.reduced_f32(), shape=(32, 4), steps=3,
                 serve_argv=["--reduced", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "16", "--new-tokens", "4"])


def test_chip_launch_phase_on_cpu(tmp_path, counted_kernels, capsys):
    got = chip_smoke.launch_phase(torch, CPU, counted_kernels, "cpu",
                                  group=_gloo_group(tmp_path), **REHEARSAL)
    L = REHEARSAL["cfg"].num_layers
    assert got == {"wgmma": {"train_step": 2 * L, "serve_prefill": L},
                   "bwd": {"train_step": L}}
    out = capsys.readouterr().out
    assert "(bit-equal)" in out and "fails, as it must" in out
    assert not dist.is_initialized()


def test_chip_launch_phase_catches_the_late_pipeline(tmp_path, counted_kernels, monkeypatch):
    """The first-loss check itself fails on a pipeline one batch late (the
    phase plants the same fault and must see it fail)."""
    real = ttrain.DataPipeline
    monkeypatch.setattr(ttrain, "DataPipeline",
                        lambda **kw: real(**{**kw, "start_step": kw["start_step"] + 1}))
    with pytest.raises(SystemExit):
        chip_smoke.launch_phase(torch, CPU, counted_kernels, "cpu",
                                group=_gloo_group(tmp_path), **REHEARSAL)
    assert not dist.is_initialized()


def test_chip_launch_phase_counts_launches_exactly(tmp_path, counted_kernels, monkeypatch):
    """Without remat the forward runs once a layer: the launch count fails."""
    real = ttrain.LM
    monkeypatch.setattr(ttrain, "LM", lambda *a, **kw: real(*a, **{**kw, "remat": False}))
    with pytest.raises(SystemExit):
        chip_smoke.launch_phase(torch, CPU, counted_kernels, "cpu",
                                group=_gloo_group(tmp_path), **REHEARSAL)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# against the reference's run (last: its subprocess runs meanwhile)
# ---------------------------------------------------------------------------

def test_reduced_run_matches_the_reference(reference_run, tmp_path):
    """The port's ``train`` of the reference's ``--reduced --steps 12`` in
    f32 from its params: every step's loss within rel 1e-4 and gradient
    norm within 1e-3 of the reference's."""
    ref = reference_run.wait()
    assert ref["devices"] == 1  # the reference's mesh is 1 x 1, its heads unpadded
    assert "arch=llama3.2-1b (0.4M params) mesh={'data': 1, 'model': 1}" in ref["stdout"]
    want = np.array(ref["first"])
    assert want.shape == (worker.STEPS, 2)
    got = ttrain.train(worker.reduced_f32(), ttrain.REDUCED_SHAPE, steps=worker.STEPS,
                       ckpt_dir=str(tmp_path), device="cpu",
                       params=params_from_jax(ref["init"], "cpu", torch.float32), log=_quiet)
    np.testing.assert_allclose(got["loss"], want[:, 0], rtol=LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], want[:, 1], rtol=GNORM_TOL)


def test_reference_resume_applies_batch_10_twice_pinned(reference_run):
    """ROADMAP §3, "the reference's resume applies one batch twice": its
    launcher saves the state after batch 10's update under label 10 (AdamW
    step 11) and its resume starts at batch 10, so the resumed run's first
    step applies batch 10 a second time (its loss is not the uninterrupted
    run's at batch 10), and saves again under label 10, now AdamW step 12.
    The port's label 11 holds step 11
    (``test_resume_is_the_uninterrupted_run``)."""
    ref = reference_run.wait()
    assert ref["labels"] == {"first": {"step_00000010": 11},
                             "resumed": {"step_00000010": 12}}
    assert "resumed at step 10" in ref["stdout"]
    first, resumed = np.array(ref["first"]), np.array(ref["resumed"])
    assert len(resumed) == 2  # batches 10 and 11
    assert abs(resumed[0, 0] - first[10, 0]) > 1e-3 * abs(first[10, 0])
