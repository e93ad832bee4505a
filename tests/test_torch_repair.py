"""The port's plan repair, synthesizer, simulator and baselines (text copies
in ``repro_torch.core``) against the reference, on the CPU.

* Parity: the same fabric, request and degradation event through both
  packages give the same ``RepairResult`` (strategy, phases kept and
  re-synthesized, the surviving group, the damage report, the seven
  transfer columns) and the same ``PlanService.metrics()``, or both raise
  ``FabricDegradedError`` with the same message. The cases are
  ``tests/test_repair.py``'s fabrics and events and ``chip_smoke.py``'s
  plan-repair phase at its fabric sizes, built by that script's own
  functions. ``synthesize*`` plans and the simulator's and baselines'
  numbers are equal to the bit.
* The repair's feasibility check without scipy (path finding by BFS, as
  the reference falls back to) gives the scipy path's outcomes.
* The reference's own suites (``tests/test_repair.py`` but its 512-NPU
  timing class and the classes that need ``repro.runtime``,
  ``tests/test_simulator_baselines.py``, ``tests/test_core_synthesis.py``)
  run against the copies, each in a namespace of its own.
* The reference's two-outcome property of repair, on the copy, over the
  fixed seeds ``range(25)`` and 60973. At 60973 the reference stops on a
  bare ``AssertionError`` (pinned below); the copy's fix in
  ``core/hierarchy.py`` returns the cold plan there.
* The repaired and cold plans of ``fig_repair_64``, and the phase's
  repaired all-reduces and reduce-scatter, run through the port's stacked
  executor at a small payload, bit-equal to the numpy round interpreter.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_repair.py
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rcore
import repro.topology as rtopo
import repro_torch.core as pcore
import repro_torch.topology as ptopo
from repro_torch.comms import primitives

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_ported import against_the_copy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PKGS = {"ref": (rcore, rtopo), "port": (pcore, ptopo)}
COLUMNS = ("chunk", "link", "src", "dst", "start", "end", "reduce")

# the reference's suites, bound to the copies
_REPAIR_NAMES = ("_delivery", "_internal_link", "_cold_degraded", "TestDegradedView",
                 "TestDamageClassification", "TestRepairStrategies", "TestPlanServiceRepair")
_REPAIR = against_the_copy("test_repair.py", only=_REPAIR_NAMES, omit=("repro.runtime",))
TestDegradedView = _REPAIR["TestDegradedView"]
TestDamageClassification = _REPAIR["TestDamageClassification"]
TestRepairStrategies = _REPAIR["TestRepairStrategies"]
TestPlanServiceRepair = _REPAIR["TestPlanServiceRepair"]
_SIM = against_the_copy("test_simulator_baselines.py")
TestShortestPath = _SIM["TestShortestPath"]
TestSimulator = _SIM["TestSimulator"]
TestBaselines = _SIM["TestBaselines"]
_SYN = against_the_copy("test_core_synthesis.py")
TestTENOps = _SYN["TestTENOps"]
TestBFS = _SYN["TestBFS"]
TestConditionBuilders = _SYN["TestConditionBuilders"]
TestSynthesis = _SYN["TestSynthesis"]
TestReductions = _SYN["TestReductions"]
TestSwitches = _SYN["TestSwitches"]
TestHeterogeneous = _SYN["TestHeterogeneous"]
_PROPERTY = against_the_copy("test_repair_property.py",
                             only=("FABRICS", "KINDS", "_delivery", "check_repair_seed"))

_internal_link = _REPAIR["_internal_link"]  # generic over either package


def _non_gateway(topo, pod: int) -> int:
    return next(n for n in topo.pods()[pod] if n not in topo.gateways(pod))


# case -> (fabric over a topology package, kind, planned first, pipeline,
# the event's keywords on that fabric): tests/test_repair.py's fabrics and
# events, and the DP ring that PlanService.program() serves
REPAIR_CASES = {
    "mp248_ag_pod0_link": (lambda t: t.multi_pod(2, 4, 8, unit_links=True), "all_gather",
                           True, False, lambda topo: dict(failed_links=[_internal_link(topo, 0)])),
    "mp248_ag_pod1_link": (lambda t: t.multi_pod(2, 4, 8, unit_links=True), "all_gather",
                           True, False, lambda topo: dict(failed_links=[_internal_link(topo, 1)])),
    "mp248_ag_boundary": (lambda t: t.multi_pod(2, 4, 8, unit_links=True), "all_gather",
                          True, False,
                          lambda topo: dict(failed_links=[topo.boundary_links()[0].id])),
    "mp248_ag_member": (lambda t: t.multi_pod(2, 4, 8, unit_links=True), "all_gather",
                        True, False, lambda topo: dict(failed_npus=[_non_gateway(topo, 0)])),
    "mp248_ag_gateway": (lambda t: t.multi_pod(2, 4, 8, unit_links=True), "all_gather",
                         True, False, lambda topo: dict(failed_npus=[topo.gateways(0)[0]])),
    "mp224_rs_unplanned": (lambda t: t.multi_pod(2, 2, 4, unit_links=True, dci_ports_per_pod=4),
                           "reduce_scatter", False, "auto",
                           lambda topo: dict(failed_links=[_internal_link(topo, 0)])),
    "tl223_ag_pod0_link": (lambda t: t.three_level(2, 2, 3, unit_links=True), "all_gather",
                           True, False, lambda topo: dict(failed_links=[_internal_link(topo, 0)])),
    "ring8_ar_link": (lambda t: t.ring(8, bidirectional=True), "all_reduce", True, "auto",
                      lambda topo: dict(failed_links=[0])),
    "ring8_ar_npu": (lambda t: t.ring(8, bidirectional=True), "all_reduce", True, "auto",
                     lambda topo: dict(failed_npus=[3])),
    # the loud refusals: every boundary link cut, a sole gateway lost, a
    # reduce's root lost
    "mp224_ag_cut": (lambda t: t.multi_pod(2, 2, 4, unit_links=True, dci_ports_per_pod=4),
                     "all_gather", True, "auto",
                     lambda topo: dict(failed_links=[l.id for l in topo.boundary_links()])),
    "mp224_dci1_gateway": (lambda t: t.multi_pod(2, 2, 4, unit_links=True, dci_ports_per_pod=1),
                           "all_gather", True, "auto",
                           lambda topo: dict(failed_npus=[topo.gateways(0)[0]])),
    "mp224_reduce_root": (lambda t: t.multi_pod(2, 2, 4, unit_links=True, dci_ports_per_pod=4),
                          "reduce", False, "auto", lambda topo: dict(failed_npus=[topo.npus[0]])),
}


def _repair(pkg: str, case: str):
    """(RepairResult or the FabricDegradedError raised, the service's
    metrics) of one case through one package's ``PlanService``."""
    core, topology = PKGS[pkg]
    fabric, kind, planned, pipeline, event = REPAIR_CASES[case]
    topo = fabric(topology)
    group = tuple(topo.npus)
    req = core.CollectiveRequest(kind, group=group, **({"root": group[0]}
                                                       if kind == "reduce" else {}))
    ev = core.DegradationEvent(**event(topo))
    svc = core.PlanService(registry=core.AlgorithmRegistry())
    try:
        if planned:
            res = svc.repair(topo, req, ev, pipeline=pipeline)
        else:
            res = svc.repairer(topo, pipeline=pipeline).repair(req, ev)
    except core.FabricDegradedError as e:
        res = e
    return res, svc.metrics()


# the cases' outcomes as the packages give them, computed once: several
# tests read them and none changes them
_repaired = functools.cache(_repair)


def _same_columns(a, b) -> None:
    for col in COLUMNS:
        x, y = getattr(a.columns, col), getattr(b.columns, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), f"column {col} differs"


def _same_result(ref, port) -> None:
    """Two packages' repair outcomes are the same: the same refusal, or the
    same strategy, group, view, damage report and plan to the bit."""
    if isinstance(ref, Exception):
        assert isinstance(port, pcore.FabricDegradedError), port
        assert str(port) == str(ref)
        return
    assert (port.strategy, port.phases_kept, port.phases_resynthesized) == \
        (ref.strategy, ref.phases_kept, ref.phases_resynthesized)
    assert port.request.fingerprint() == ref.request.fingerprint()
    assert list(port.view.links) == list(ref.view.links)
    assert (port.report.pod_internal, port.report.boundary, port.report.gateway_loss,
            port.report.unpartitioned) == (ref.report.pod_internal, ref.report.boundary,
                                           ref.report.gateway_loss, ref.report.unpartitioned)
    _same_columns(ref.algorithm, port.algorithm)
    assert ref.algorithm.makespan == port.algorithm.makespan


@pytest.mark.parametrize("case", sorted(REPAIR_CASES))
def test_repair_equals_reference(case):
    (ref, ref_m), (port, port_m) = _repaired("ref", case), _repaired("port", case)
    assert ref_m == port_m
    _same_result(ref, port)
    if not isinstance(port, Exception):
        port.algorithm.validate(mode="oracle")


def test_repair_cases_cover_both_strategies_and_refusals():
    outcomes = {case: _repaired("port", case)[0] for case in REPAIR_CASES}
    strategies = {getattr(r, "strategy", "refused") for r in outcomes.values()}
    assert strategies == {"phases", "resynth", "refused"}


# -- the chip phase's cases, built by chip_smoke.py's own functions ----------

def test_fig_repair_64_equals_reference_and_the_bench_row():
    """(a): the fig_repair_64 scenario gives the reference's repaired and
    cold plans, and BENCH_synthesis.json's row, which the phase gates."""
    got = {pkg: chip_smoke.fig_repair(*PKGS[pkg], (4, 4, 4)) for pkg in PKGS}
    _same_result(got["ref"]["res"], got["port"]["res"])
    _same_columns(got["ref"]["cold"], got["port"]["cold"])
    props = chip_smoke.repair_properties(got["port"]["res"], got["port"]["cold"])
    assert props == chip_smoke.FIG_REPAIR["fig_repair_64"][1]


@pytest.mark.parametrize("label", sorted(chip_smoke.repair_all_reduce_cases(pcore, ptopo)))
def test_repaired_all_reduce_equals_reference(label):
    """(b): the repaired all-reduces of the phase, and their healthy plans,
    through each package's PlanService. The dead member's case repairs:
    the group shrinks to the 7 survivors."""
    out = {}
    for pkg, (core, topology) in PKGS.items():
        topo, event = chip_smoke.repair_all_reduce_cases(core, topology)[label]
        svc = core.PlanService(registry=core.AlgorithmRegistry())
        healthy, res = chip_smoke.repair_all_reduce(core, svc, topo, event)
        out[pkg] = (healthy, res, svc.metrics())
    _same_columns(out["ref"][0], out["port"][0])
    _same_result(out["ref"][1], out["port"][1])
    assert out["ref"][2] == out["port"][2]
    res = out["port"][1]
    assert len(res.request.group) == (7 if res.event.failed_npus else 8)
    assert not chip_smoke.failed_parts_used(res.algorithm, res.view, res.event)


def test_boundary_cut_refuses_as_the_reference():
    """(d): every boundary link of mp222 cut: both services raise the same
    FabricDegradedError and count one repair failure."""
    out = {}
    for pkg, (core, topology) in PKGS.items():
        svc = core.PlanService(registry=core.AlgorithmRegistry())
        topo, event = chip_smoke.boundary_cut(core, topology)
        with pytest.raises(core.FabricDegradedError) as e:
            chip_smoke.repair_all_reduce(core, svc, topo, event)
        out[pkg] = (str(e.value), svc.metrics())
    assert out["ref"] == out["port"]
    assert out["port"][1]["repair_failures"] == 1


# -- the reference's repair fault at check_repair_seed(60973) ---------------

@pytest.mark.parametrize("seed", [*range(25), 60973])
def test_repair_two_outcomes_on_the_copy(seed):
    """The reference's property (a valid plan with the cold plan's final
    conditions, or ``FabricDegradedError``) on fixed seeds."""
    _PROPERTY["check_repair_seed"](seed)


def test_reference_repair_fault_at_seed_60973_is_pinned():
    """The reference's ``PlanRepairer`` stops in path finding with a bare
    ``AssertionError`` on three_level(2, 2, 2), a reduce_scatter, links
    [11, 18, 20] and NPU 5 failed, both in its own property check and in
    chip_smoke.py's case (c). The copy's fix (a local phase its degraded
    sub-fabric cannot connect raises ``HierarchyError``, and the engine
    goes flat) returns the cold plan there: the plan case (c) runs."""
    from test_repair_property import check_repair_seed as reference_check

    match = r"chunk 2: unreachable dests \[0, 1\]"
    with pytest.raises(AssertionError, match=match):
        reference_check(60973)
    rp, req, event = chip_smoke.seed_60973(rcore, rtopo)
    with pytest.raises(AssertionError, match=match):
        rp.repair(req, event)
    rp, req, event = chip_smoke.seed_60973(pcore, ptopo)
    res = rp.repair(req, event)
    res.algorithm.validate(mode="oracle")
    assert res.strategy == "resynth" and res.request.group == (0, 1, 2, 3, 4, 6, 7)
    dtopo = ptopo.three_level(2, 2, 2, unit_links=True).degraded(
        event.failed_links, event.failed_npus).topology
    cold = pcore.SynthesisEngine(dtopo, registry=pcore.AlgorithmRegistry()).collective(
        res.request)
    _same_columns(res.algorithm, cold)


# -- the feasibility check without scipy -------------------------------------

FEASIBILITY_CASES = ("mp248_ag_member", "ring8_ar_link", "mp224_rs_unplanned",
                     "mp224_ag_cut", "mp224_dci1_gateway", "mp224_reduce_root")


@pytest.mark.parametrize("mode", ["hop_matrix", "bfs"])
@pytest.mark.parametrize("case", FEASIBILITY_CASES)
def test_repair_without_scipy_equals_the_scipy_path(monkeypatch, case, mode):
    """``PlanRepairer._check_feasible`` takes scipy's strongly connected
    components where scipy is installed; without it, the all-pairs hop
    matrix, and without that too, a BFS from every member
    (core/repair.py:48-52, topology.hop_matrix). Forced onto each
    fallback, the copy repairs or refuses each case as the scipy path
    does, with the same plan."""
    want, _ = _repaired("port", case)
    from repro_torch.core import repair
    from repro_torch.topology import topology

    monkeypatch.setattr(repair, "_sp_scc", None)
    monkeypatch.setattr(repair, "_sp_csr_matrix", None)
    if mode == "bfs":
        monkeypatch.setattr(topology, "_sp_shortest_path", None)
    got, _ = _repair("port", case)
    if isinstance(want, Exception):
        assert isinstance(got, pcore.FabricDegradedError), got
        return
    assert got.strategy == want.strategy
    _same_columns(want.algorithm, got.algorithm)


# -- synthesizer, simulator, baselines ---------------------------------------

# case -> a plan over a package's (core, topology): tests/test_core_synthesis.py's fabrics
SYNTH_CASES = {
    **{f"ring{n}_ag": (lambda c, t, n=n: c.synthesize_all_gather(t.ring(n), list(range(n))))
       for n in (3, 4, 7)},
    "line5_ag": lambda c, t: c.synthesize_all_gather(t.line(5), list(range(5))),
    "mesh34_ag": lambda c, t: c.synthesize_all_gather(t.mesh2d(3, 4), list(range(12))),
    "torus33_ag": lambda c, t: c.synthesize_all_gather(t.torus2d(3, 3), list(range(9))),
    "hypercube3_ag": lambda c, t: c.synthesize_all_gather(t.hypercube(3), list(range(8))),
    "mesh44_a2a": lambda c, t: c.synthesize_all_to_all(t.mesh2d(4, 4), list(range(16))),
    "mesh33_scatter": lambda c, t: c.synthesize(t.mesh2d(3, 3), c.scatter(list(range(9)), 4)),
    "mesh33_gather": lambda c, t: c.synthesize(t.mesh2d(3, 3), c.gather(list(range(9)), 0)),
    "mesh33_broadcast": lambda c, t: c.synthesize(t.mesh2d(3, 3),
                                                  c.broadcast(list(range(9)), 8)),
    "mesh33_ag_corners": lambda c, t: c.synthesize_all_gather(t.mesh2d(3, 3), [0, 2, 8]),
    "mesh33_joint": lambda c, t: _joint(c, t),
    "mesh33_reduce": lambda c, t: c.synthesize_reduce(t.mesh2d(3, 3), list(range(9)), root=4),
    "ring4b_rs": lambda c, t: c.synthesize_reduce_scatter(t.ring(4, bidirectional=True),
                                                          list(range(4))),
    "hypercube3_rs": lambda c, t: c.synthesize_reduce_scatter(t.hypercube(3), list(range(8))),
    "mesh33_rs_group": lambda c, t: c.synthesize_reduce_scatter(t.mesh2d(3, 3), [0, 4, 8]),
    "ring8b_ar": lambda c, t: c.synthesize_all_reduce(t.ring(8, bidirectional=True),
                                                      list(range(8))),
    "mesh44_ar_pipelined": lambda c, t: c.synthesize_all_reduce(t.mesh2d(4, 4), list(range(16)),
                                                                pipelined=True),
    "star4_ag_no_multicast": lambda c, t: c.synthesize_all_gather(
        t.star_switch(4, multicast=False), list(range(4))),
    "star6_a2a_buffer1": lambda c, t: c.synthesize_all_to_all(
        t.star_switch(6, buffer_limit=1), list(range(6))),
    "two_level_a2a": lambda c, t: c.synthesize_all_to_all(
        t.two_level_switch(2, npus_per_node=4), list(range(8)), bytes=512.0),
}


def _joint(c, t):
    ids = c.ChunkIds()
    v = c.all_to_allv([0, 1, 2], [[0, 2, 2], [1, 0, 1], [1, 1, 0]], ids=ids)
    ag = c.all_gather([6, 7, 8], ids=ids)
    return c.synthesize_joint(t.mesh2d(3, 3), [("pg0", v), ("pg1", ag)])


@pytest.mark.parametrize("case", sorted(SYNTH_CASES))
def test_synthesize_equals_reference(case):
    ref, port = (SYNTH_CASES[case](*PKGS[pkg]) for pkg in ("ref", "port"))
    _same_columns(ref, port)
    assert ref.makespan == port.makespan and ref.name == port.name
    assert [repr(c) for c in ref.conditions] == [repr(c) for c in port.conditions]
    port.validate()


def _sim_numbers(res) -> tuple:
    return (res.makespan, sorted(res.completion.items()), sorted(res.link_busy.items()),
            [tuple(getattr(t, col) for col in COLUMNS) for t in res.transfers])


# case -> the simulator's or a baseline's result over (core, topology):
# tests/test_simulator_baselines.py's cases
SIM_CASES = {
    "flow_line3": lambda c, t: c.simulate_flows(
        t.line(3), [c.Flow(0, 2.0, c.shortest_path_links(t.line(3), 0, 2))]),
    "flows_release": lambda c, t: c.simulate_flows(
        t.line(2), [c.Flow(0, 1.0, [0], release=5.0), c.Flow(1, 1.0, [0])]),
    "direct_a2a_mesh33": lambda c, t: c.direct_all_to_all(t.mesh2d(3, 3), list(range(9))),
    "direct_a2a_mesh44": lambda c, t: c.direct_all_to_all(t.mesh2d(4, 4), list(range(16))),
    "direct_a2a_mesh44_row": lambda c, t: c.direct_all_to_all(t.mesh2d(4, 4), [0, 1, 2, 3]),
    "ring_ag_ring6": lambda c, t: c.ring_all_gather(t.ring(6), list(range(6))),
    "ring_ag_torus33": lambda c, t: c.ring_all_gather(t.torus2d(3, 3), list(range(9))),
    "direct_ag_mesh33": lambda c, t: c.direct_all_gather(t.mesh2d(3, 3), list(range(9))),
    "replay_ring4_ag": lambda c, t: c.replay_algorithm(
        c.synthesize_all_gather(t.ring(4), [0, 1, 2, 3])),
    "replay_mesh44_a2a": lambda c, t: c.replay_algorithm(
        c.synthesize_all_to_all(t.mesh2d(4, 4), list(range(16)))),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulator_and_baselines_equal_reference(case):
    ref, port = (SIM_CASES[case](*PKGS[pkg]) for pkg in ("ref", "port"))
    assert _sim_numbers(ref) == _sim_numbers(port)
    assert ref.busy_timeline(64, bins=10) == port.busy_timeline(64, bins=10)
    assert rcore.collective_bandwidth(ref, 4.0) == pcore.collective_bandwidth(port, 4.0)


def test_shortest_path_and_phase_breakdown_equal_reference():
    for n, (s, d) in ((4, (0, 3)), (6, (5, 1))):
        assert rcore.shortest_path_links(rtopo.line(n), s, d) == \
            pcore.shortest_path_links(ptopo.line(n), s, d)
    ref, port = (c.synthesize_all_reduce(t.mesh2d(4, 4), list(range(16)), pipelined=True)
                 for c, t in PKGS.values())
    assert rcore.phase_breakdown(ref) == pcore.phase_breakdown(port)


# -- repaired plans through the stacked executor -----------------------------

def _bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_fig_repair_64_plans_execute_on_the_stacked_backend():
    """(a) on the CPU: the repaired and the cold plan of fig_repair_64,
    lowered, gather 8 f32 a shard over 64 ranks bit for bit as the numpy
    interpreter does, which is exactly the plain gather; neither plan
    sends over the failed link."""
    got = chip_smoke.fig_repair(pcore, ptopo, (4, 4, 4))
    res = got["res"]
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    want = chip_smoke.exec_reference("all_gather", range(64), x)
    for alg, view in ((res.algorithm, res.view), (got["cold"], got["cold_view"])):
        assert not chip_smoke.failed_parts_used(alg, view, res.event)
        prog = primitives.lower_algorithm(alg, key="test fig_repair_64")
        out = primitives.pccl_all_gather(torch.from_numpy(x), None, res.request,
                                         program=prog).numpy()
        interp = primitives.interpret_collective("all_gather", x, None, res.request,
                                                 program=prog)
        assert _bit_equal(out, interp)
        assert np.array_equal(out, want)


@pytest.mark.parametrize("label", sorted(chip_smoke.repair_all_reduce_cases(pcore, ptopo)))
def test_repaired_all_reduce_executes_on_the_stacked_backend(label):
    """(b) on the CPU at 56 f32 a rank: bit-equal to the interpreter,
    within the conformance tolerance of the survivors' sum, a dead rank's
    NaN row left at exact zeros and every row finite."""
    topo, event = chip_smoke.repair_all_reduce_cases(pcore, ptopo)[label]
    svc = pcore.PlanService(registry=pcore.AlgorithmRegistry())
    _, res = chip_smoke.repair_all_reduce(pcore, svc, topo, event)
    group = list(res.request.group)
    x = np.random.default_rng(1).standard_normal((8, 56)).astype(np.float32)
    x[[d for d in range(8) if d not in group]] = np.nan
    prog = primitives.lower_algorithm(res.algorithm, key="test repaired all-reduce")
    out = primitives.pccl_all_reduce(torch.from_numpy(x), None, res.request,
                                     program=prog).numpy()
    assert _bit_equal(out, primitives.interpret_collective("all_reduce", x, None, res.request,
                                                           program=prog))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, chip_smoke.exec_reference("all_reduce", group, x),
                               rtol=chip_smoke.EXEC_TOL, atol=chip_smoke.EXEC_TOL)


def test_seed_60973_plan_executes_on_the_stacked_backend():
    """(c) on the CPU: the copy's plan at check_repair_seed(60973), a
    reduce-scatter over the 7 survivors, bit-equal to the interpreter and
    within the conformance tolerance of the plain sum."""
    rp, req, event = chip_smoke.seed_60973(pcore, ptopo)
    res = rp.repair(req, event)
    group = list(res.request.group)
    x = np.random.default_rng(2).standard_normal((8, len(group), 8)).astype(np.float32)
    prog = primitives.lower_algorithm(res.algorithm, key="test seed 60973")
    out = primitives.pccl_reduce_scatter(torch.from_numpy(x), None, res.request,
                                         program=prog).numpy()
    assert _bit_equal(out, primitives.interpret_collective("reduce_scatter", x, None,
                                                           res.request, program=prog))
    np.testing.assert_allclose(out, chip_smoke.exec_reference("reduce_scatter", group, x),
                               rtol=chip_smoke.EXEC_TOL, atol=chip_smoke.EXEC_TOL)
