"""The port's executor and ``pccl_*`` collectives (``repro_torch.comms``)
against the reference's buffer plans, its numpy round interpreter and the
numpy references of the conformance suite, on the CPU.

The reference runs these collectives only on a multi-device jax mesh
(``mesh``-marked tests). Here the stacked backend holds every rank in one
tensor, so the semantics run in one process; one test runs eight gloo
ranks through ``DistBackend``.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402, F401

from _exec_harness import KINDS, assert_conformant, make_input, reference  # noqa: E402
from test_comms import _simulate  # noqa: E402
from test_torch_planner import (  # noqa: E402
    FABRICS,
    FIG_EXEC,
    SUBSET_CASES,
    synthesize,
    topo,
)
from test_torch_planner import KINDS as PLAN_KINDS  # noqa: E402

from repro.comms.executor import plan_buffers as ref_plan_buffers  # noqa: E402
from repro.core.translate import to_ppermute_program as ref_translate  # noqa: E402

import _torch_dist_worker as dist_worker  # noqa: E402
from repro_torch.comms import executor, primitives, selftest  # noqa: E402
from repro_torch.comms.executor import (  # noqa: E402
    DistBackend,
    StackedBackend,
    execute_program,
    gather_slots,
    interpret_rounds,
    plan_buffers,
)
from repro_torch.core import CollectiveRequest  # noqa: E402
from repro_torch.core.translate import to_ppermute_program  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 8

# tests/test_exec_conformance.py's routes: (fabric, request keywords)
ROUTES = {
    "flat_ring": ("ring8", {"hierarchy": "never"}),
    "hier_grid": ("grid23", {"hierarchy": "always"}),
    "hier_multipod": ("mp222", {"hierarchy": "always"}),
    "te_multipod": ("mp222_skew", {"hierarchy": "always", "gateway_strategy": "te"}),
}

# every program of test_torch_planner.py: (fabric, kind label or fig_exec
# tag, group, request keywords)
PROGRAMS = (
    [(f, label, None, {**FABRICS[f][1], **PLAN_KINDS[label][1]})
     for f in sorted(FABRICS) for label in sorted(PLAN_KINDS)]
    + [(f, label, g, {**FABRICS[f][1], **PLAN_KINDS[label][1]})
       for f, g in SUBSET_CASES for label in sorted(PLAN_KINDS)]
    + [(FIG_EXEC[tag][0], tag, None, FIG_EXEC[tag][2]) for tag in sorted(FIG_EXEC)]
)


def _programs(case):
    """(reference program, port program) of one PROGRAMS case."""
    fabric, label, group, kw = case
    kind = FIG_EXEC[label][1] if label in FIG_EXEC else PLAN_KINDS[label][0]
    group = topo("ref", fabric).npus if group is None else group
    ref = ref_translate(synthesize("ref", fabric, kind, group, **kw))
    port = to_ppermute_program(synthesize("port", fabric, kind, group, **kw))
    return ref, port


def _id(case):
    fabric, label, group, _ = case
    return f"{fabric}-{label}" + ("" if group is None else "-" + "_".join(map(str, group)))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("case", PROGRAMS, ids=_id)
def test_plan_buffers_equal_reference(case):
    ref_prog, prog = _programs(case)
    ref, port = ref_plan_buffers(ref_prog), plan_buffers(prog)
    assert (port.num_devices, port.num_slots) == (ref.num_devices, ref.num_slots)
    assert port.slot_of == ref.slot_of
    assert len(port.rounds) == len(ref.rounds)
    for a, b in zip(ref.rounds, port.rounds):
        assert a.perm == b.perm
        for name in ("send_slot", "recv_slot", "is_recv", "is_reduce"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("case", PROGRAMS, ids=_id)
def test_stacked_executor_equals_reference_interpreter(case):
    """The stacked backend on the CPU and the port's numpy interpreter give
    the bits of tests/test_comms.py:_simulate run on the reference plan,
    from a random buffer (trash slots included)."""
    ref_prog, prog = _programs(case)
    ref, plan = ref_plan_buffers(ref_prog), plan_buffers(prog)
    rng = np.random.default_rng(len(_id(case)))
    buf = rng.standard_normal((plan.num_devices, plan.buffer_slots, 3)).astype(np.float32)
    want = _simulate(ref, buf.copy())
    got = execute_program(plan, torch.from_numpy(buf.copy())).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(interpret_rounds(plan, buf.copy())), _bits(want))


def _run(kind, fabric, group, kw, seed, **extra):
    t = topo("port", fabric)
    req = CollectiveRequest(kind, group=tuple(group), **kw)
    x = make_input(kind, group, N, seed=seed)
    got = getattr(primitives, f"pccl_{kind}")(torch.from_numpy(x), t, req, **extra)
    return x, got.numpy(), primitives.interpret_collective(kind, x, t, req)


def _check(kind, group, x, got, interp):
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(interp))
    want = reference(kind, group, x)
    for d in range(N):
        if d in group:
            assert_conformant(kind, got[d], want[d], f"{kind} member device {d}")
        else:
            np.testing.assert_array_equal(_bits(got[d]), _bits(np.zeros_like(got[d])),
                                          err_msg=f"{kind}: non-participant {d} touched")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_full_group_conformance(route, kind):
    fabric, kw = ROUTES[route]
    group = tuple(range(N))
    _check(kind, group, *_run(kind, fabric, group, kw, seed=len(route) * 7 + len(kind)))


@pytest.mark.parametrize("route", ["flat_ring", "hier_grid"])
def test_pipelined_all_reduce(route):
    fabric, kw = ROUTES[route]
    group = tuple(range(N))
    _check("all_reduce", group, *_run("all_reduce", fabric, group,
                                      {**kw, "pipelined": True}, seed=7))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", range(len(SUBSET_CASES)), ids=[c[0] for c in SUBSET_CASES])
def test_subset_groups_leave_non_participants_untouched(case, kind):
    fabric, group = SUBSET_CASES[case]
    _check(kind, group, *_run(kind, fabric, group, FABRICS[fabric][1], seed=case + 3))


def test_all_gather_tiled_and_program_override():
    """``tiled`` concatenates the gathered rows; ``program=`` runs a lowered
    plan with no topology."""
    t = topo("port", "ring8")
    req = CollectiveRequest("all_gather", group=tuple(range(N)))
    prog_plan = primitives.synthesize_program(t, req)
    x = torch.arange(N * 6, dtype=torch.float32).reshape(N, 2, 3)
    stacked = primitives.pccl_all_gather(x, None, req, program=prog_plan)
    tiled = primitives.pccl_all_gather(x, None, req, program=prog_plan, tiled=True)
    assert stacked.shape == (N, N, 2, 3) and tiled.shape == (N, N * 2, 3)
    assert torch.equal(tiled, stacked.reshape(N, N * 2, 3))
    assert torch.equal(stacked[3], x)


def test_collectives_refuse_bad_input():
    t = topo("port", "ring8")
    req = CollectiveRequest("all_reduce", group=tuple(range(N)))
    with pytest.raises(ValueError, match="must divide"):
        primitives.pccl_all_reduce(torch.zeros(N, 12), t, req)
    with pytest.raises(ValueError, match="of kind 'all_reduce'"):
        primitives.pccl_all_gather(torch.zeros(N, 16), t, req)
    with pytest.raises(ValueError, match="8 devices"):
        primitives.pccl_all_reduce(torch.zeros(4, 16), t, req)
    with pytest.raises(TypeError, match="CollectiveSpec or CollectiveRequest"):
        primitives.synthesize_program(t, ("all_reduce", (0, 1)))


def test_round_tables_and_gather_slots():
    prog, plan = primitives.synthesize_program(
        topo("port", "line8"), CollectiveRequest("all_gather", group=(0, 3, 7)))
    send, recv, red = plan.round_tables("cpu")
    assert send.dtype == recv.dtype == torch.int64 and red.dtype == torch.bool
    assert send.shape == recv.shape == red.shape == (prog.num_rounds, N)
    assert plan.round_tables("cpu")[0] is send  # one copy per device
    for r, rt in enumerate(plan.rounds):
        assert np.array_equal(recv[r].numpy(), rt.recv_slot)
    buf = torch.arange(N * plan.buffer_slots, dtype=torch.float32).reshape(N, -1)
    chunks = sorted(prog.chunk_holders)
    got = gather_slots(plan, buf, chunks)
    for d in range(N):
        for j, c in enumerate(chunks):
            assert got[d, j] == buf[d, plan.slot_of.get((d, c), plan.num_slots)]


def test_plan_cache_hits_and_keys_on_digest():
    executor.clear_plan_cache()
    p1 = to_ppermute_program(synthesize("port", "ring8", "all_gather", range(8)))
    p2 = to_ppermute_program(synthesize("port", "ring8", "all_reduce", range(8)))
    a = executor.plan_buffers_cached(p1, "same")
    b = executor.plan_buffers_cached(p2, "same")
    assert a is not b and executor.plan_buffers_cached(p1, "same") is a
    assert executor.plan_cache_stats == {"hits": 1, "misses": 2}


def test_send_before_arrival_raises():
    prog = to_ppermute_program(synthesize("port", "ring8", "all_gather", range(8)))
    prog.rounds = prog.rounds[1:]  # the first hops never happen
    prog._digest = None
    with pytest.raises(AssertionError, match="before arrival"):
        plan_buffers(prog)


def test_selftest_on_cpu_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.comms.selftest", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[selftest] ALL PASS"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        selftest.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        selftest.main(["--device", "cuda"])


def test_dist_backend_needs_an_initialized_group():
    with pytest.raises(RuntimeError, match="initialized"):
        DistBackend()
    assert StackedBackend.rank is None


def test_dist_backend_gloo_8_ranks_equals_stacked(tmp_path):
    """Eight gloo ranks, one process each, run the ring8 all-reduce and the
    line8 (0, 3, 7) all-gather through DistBackend: the bits of the stacked
    backend on the same program. Fails, and stops its processes, after
    100 s rather than hang."""
    import torch.multiprocessing as mp

    world = 8
    ctx = mp.start_processes(dist_worker.run_rank, nprocs=world, join=False,
                             args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
                             start_method="spawn")
    deadline = time.monotonic() + 100
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the gloo ranks did not finish in 100 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for name, (kind, t, spec, x) in dist_worker.cases().items():
        want = getattr(primitives, f"pccl_{kind}")(torch.from_numpy(x), t, spec).numpy()
        got = np.stack([np.load(tmp_path / f"{name}.{r}.npy") for r in range(world)])
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
        assert_conformant(kind, got[list(spec.group)],
                          reference(kind, spec.group, x)[list(spec.group)], name)
