"""Finite switch buffers and shared topologies in the port's planner copy.

The reference's synthesis checks a limited switch's buffer only when a
chunk arrives, and its all-reduce and hierarchical phases meet in switches
that hold a chunk from one phase to the next, so many of its plans on
limited-buffer fabrics fail ``validate()`` (``switch N buffer exceeded``).
The copy keeps each chunk's whole stay within the buffer (marked fixes in
``core/ten.py``, ``core/pathfinding.py`` and ``core/engine.py``): here its
plans validate on the switch generators' grid and on 200 fixed random
fabrics, the reference's outcome on the grid is pinned beside them, and on
every fabric without a limited switch the copy's plans stay the
reference's to the bit. The copy's path-finding scratch is per thread: four
threads synthesizing on one topology give the single-thread plans.
"""

import functools
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

import repro.core as rcore
import repro.topology as rtopo

import repro_torch.core as pcore
import repro_torch.topology as ptopo
from repro_torch.core import pathfinding

from _torch_ported import against_the_copy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PKGS = {"ref": (rcore, rtopo), "port": (pcore, ptopo)}
COLUMNS = ("chunk", "link", "src", "dst", "start", "end", "reduce")

# the reference's differential suite (event search = level search, the
# heterogeneous search on homogeneous links) bound to the copy, whose three
# searches keep whole stays
_DIFF = against_the_copy("test_pathfinding_diff.py")
test_all_to_all_differential = _DIFF["test_all_to_all_differential"]
test_all_gather_differential = _DIFF["test_all_gather_differential"]
test_process_group_differential = _DIFF["test_process_group_differential"]
test_release_times_differential = _DIFF["test_release_times_differential"]
test_synthesized_algorithms_identical = _DIFF["test_synthesized_algorithms_identical"]
test_unreachable_raises_same = _DIFF["test_unreachable_raises_same"]
test_continuous_still_matches_on_homogeneous = _DIFF["test_continuous_still_matches_on_homogeneous"]
_PROPERTY = against_the_copy("test_core_property.py")

# the switch generators at limited buffers: fabric -> its call on a topology package
GRID = {
    **{f"star{n}_b{b}": (lambda t, n=n, b=b: t.star_switch(n, buffer_limit=b))
       for n in (4, 6, 8, 16) for b in (1, 2, 4)},
    **{f"two{p}x4_b{b}": (lambda t, p=p, b=b: t.two_level_switch(p, npus_per_node=4,
                                                                buffer_limit=b))
       for p in (2, 4) for b in (1, 2, 4)},
}
# kind label -> (kind, pipelined)
KINDS = {"all_gather": ("all_gather", False), "all_to_all": ("all_to_all", False),
         "reduce_scatter": ("reduce_scatter", False), "all_reduce": ("all_reduce", False),
         "all_reduce_pipelined": ("all_reduce", True)}
# the reference's plans on the grid that validate() rejects, with its error;
# every other case of the grid validates in the reference too
REF_FAULTS = {
    "star4_b1-all_reduce": "switch 4 buffer exceeded (2 > 1)",
    "star4_b1-all_reduce_pipelined": "switch 4 buffer exceeded (2 > 1)",
    "star4_b2-all_reduce": "switch 4 buffer exceeded (3 > 2)",
    "star4_b2-all_reduce_pipelined": "switch 4 buffer exceeded (3 > 2)",
    "star4_b4-all_to_all": "switch 4 buffer exceeded (5 > 4)",
    "star6_b1-all_reduce": "switch 6 buffer exceeded (2 > 1)",
    "star6_b1-all_reduce_pipelined": "switch 6 buffer exceeded (2 > 1)",
    "star6_b2-all_reduce": "switch 6 buffer exceeded (3 > 2)",
    "star6_b2-all_reduce_pipelined": "switch 6 buffer exceeded (3 > 2)",
    "star6_b4-all_to_all": "switch 6 buffer exceeded (5 > 4)",
    "star6_b4-all_reduce": "switch 6 buffer exceeded (5 > 4)",
    "star6_b4-all_reduce_pipelined": "switch 6 buffer exceeded (5 > 4)",
    "star8_b1-all_reduce": "switch 8 buffer exceeded (2 > 1)",
    "star8_b1-all_reduce_pipelined": "switch 8 buffer exceeded (2 > 1)",
    "star8_b2-all_reduce": "switch 8 buffer exceeded (3 > 2)",
    "star8_b2-all_reduce_pipelined": "switch 8 buffer exceeded (3 > 2)",
    "star8_b4-all_to_all": "switch 8 buffer exceeded (5 > 4)",
    "star8_b4-all_reduce": "switch 8 buffer exceeded (5 > 4)",
    "star8_b4-all_reduce_pipelined": "switch 8 buffer exceeded (5 > 4)",
    "star16_b1-all_reduce": "switch 16 buffer exceeded (2 > 1)",
    "star16_b1-all_reduce_pipelined": "switch 16 buffer exceeded (2 > 1)",
    "star16_b2-all_reduce": "switch 16 buffer exceeded (3 > 2)",
    "star16_b2-all_reduce_pipelined": "switch 16 buffer exceeded (3 > 2)",
    "star16_b4-all_to_all": "switch 16 buffer exceeded (5 > 4)",
    "star16_b4-all_reduce": "switch 16 buffer exceeded (5 > 4)",
    "star16_b4-all_reduce_pipelined": "switch 16 buffer exceeded (5 > 4)",
    "two2x4_b1-all_gather": "switch 8 buffer exceeded (2 > 1)",
    "two2x4_b1-all_to_all": "switch 9 buffer exceeded (2 > 1)",
    "two2x4_b1-reduce_scatter": "switch 9 buffer exceeded (2 > 1)",
    "two2x4_b1-all_reduce": "switch 8 buffer exceeded (2 > 1)",
    "two2x4_b1-all_reduce_pipelined": "switch 8 buffer exceeded (2 > 1)",
    "two2x4_b2-all_gather": "switch 8 buffer exceeded (3 > 2)",
    "two2x4_b2-all_to_all": "switch 8 buffer exceeded (3 > 2)",
    "two2x4_b2-reduce_scatter": "switch 9 buffer exceeded (3 > 2)",
    "two2x4_b2-all_reduce": "switch 8 buffer exceeded (3 > 2)",
    "two2x4_b2-all_reduce_pipelined": "switch 8 buffer exceeded (3 > 2)",
    "two2x4_b4-all_to_all": "switch 8 buffer exceeded (5 > 4)",
    "two2x4_b4-all_reduce": "switch 9 buffer exceeded (5 > 4)",
    "two2x4_b4-all_reduce_pipelined": "switch 9 buffer exceeded (5 > 4)",
    "two4x4_b1-all_gather": "switch 16 buffer exceeded (2 > 1)",
    "two4x4_b1-all_to_all": "switch 17 buffer exceeded (2 > 1)",
    "two4x4_b1-reduce_scatter": "switch 17 buffer exceeded (2 > 1)",
    "two4x4_b1-all_reduce": "switch 16 buffer exceeded (2 > 1)",
    "two4x4_b1-all_reduce_pipelined": "switch 16 buffer exceeded (2 > 1)",
    "two4x4_b2-all_gather": "switch 16 buffer exceeded (3 > 2)",
    "two4x4_b2-all_to_all": "switch 16 buffer exceeded (3 > 2)",
    "two4x4_b2-reduce_scatter": "switch 17 buffer exceeded (3 > 2)",
    "two4x4_b2-all_reduce": "switch 16 buffer exceeded (3 > 2)",
    "two4x4_b2-all_reduce_pipelined": "switch 16 buffer exceeded (3 > 2)",
    "two4x4_b4-all_gather": "switch 16 buffer exceeded (5 > 4)",
    "two4x4_b4-all_to_all": "switch 16 buffer exceeded (5 > 4)",
    "two4x4_b4-reduce_scatter": "switch 20 buffer exceeded (5 > 4)",
    "two4x4_b4-all_reduce": "switch 19 buffer exceeded (5 > 4)",
    "two4x4_b4-all_reduce_pipelined": "switch 19 buffer exceeded (5 > 4)",
}
CASES = [f"{f}-{k}" for f in GRID for k in KINDS]


def _plan(pkg: str, topo, label: str, group=None):
    core = PKGS[pkg][0]
    kind, pipelined = KINDS[label]
    group = tuple(topo.npus) if group is None else tuple(group)
    return core.SynthesisEngine(topo).collective(
        core.CollectiveRequest(kind, group=group, pipelined=pipelined))


@functools.lru_cache(maxsize=None)
def _grid_plan(pkg: str, case: str):
    fabric, label = case.split("-")
    return _plan(pkg, GRID[fabric](PKGS[pkg][1]), label)


@pytest.mark.parametrize("case", CASES)
def test_copy_plan_keeps_the_buffers(case):
    """The copy's plan validates (links, causality, buffers, every
    destination's contributions) and fills no limited switch past its
    limit, for the reference's conditions."""
    alg = _grid_plan("port", case)
    alg.validate()
    topo = alg.topology
    peaks = chip_smoke.switch_peaks(alg)
    assert peaks and all(p <= topo.nodes[sw].buffer_limit for sw, p in peaks.items())
    ref = _grid_plan("ref", case)
    assert [repr(c) for c in alg.conditions] == [repr(c) for c in ref.conditions]


@pytest.mark.parametrize("case", CASES)
def test_reference_outcome_pinned(case):
    """The reference's own outcome on the same case, pinned: its plan
    validates, or validate() names the overfilled switch."""
    alg = _grid_plan("ref", case)
    want = REF_FAULTS.get(case)
    if want is None:
        alg.validate()
        return
    with pytest.raises(AssertionError) as e:
        alg.validate()
    assert str(e.value) == want


def test_copy_plan_unchanged_where_the_reference_keeps_the_buffers():
    """A plan whose every stay already fits is the reference's to the bit:
    the copy re-times only stays that meet a full buffer."""
    for case in ("star6_b1-all_to_all", "star8_b2-all_to_all", "star16_b1-all_gather",
                 "two2x4_b4-all_gather", "two2x4_b4-reduce_scatter"):
        ref, port = _grid_plan("ref", case), _grid_plan("port", case)
        ref.validate()
        for col in COLUMNS:
            assert np.array_equal(getattr(ref.columns, col), getattr(port.columns, col)), case


def test_chip_smoke_switch_helpers():
    """chip_smoke.py's switch buffers phase on the CPU, in part: its peak
    count reads a plan that validates at the limit, and validate()
    rejects its planted fault (one arrival shifted into a full buffer),
    which the same count reads over the limit."""
    alg = _grid_plan("port", "star8_b1-all_gather")
    assert chip_smoke.switch_peaks(alg) == {8: 1}
    planted = chip_smoke.switch_fault(alg)
    assert chip_smoke.switch_peaks(planted) == {8: 2}
    assert len(planted.transfers) == len(alg.transfers)
    with pytest.raises(AssertionError, match=r"switch 8 buffer exceeded \(2 > 1\)"):
        planted.validate()


# -- fixed random fabrics ---------------------------------------------------

connected_topologies = _PROPERTY["connected_topologies"]
groups_of = _PROPERTY["groups_of"]


@pytest.mark.parametrize("label", ["all_gather", "all_to_all", "all_reduce"])
@settings(max_examples=200, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.filter_too_much, HealthCheck.too_slow])
@given(data=st.data())
def test_random_limited_fabrics(label, data):
    """tests/test_core_property.py's random fabrics with a switch of a
    limited buffer (multicast or not), drawn the same way every run: every
    copy plan validates."""
    topo = data.draw(connected_topologies(max_npus=6, switches=True))
    assume(topo.csr().limited_switches)
    group = data.draw(groups_of(topo))
    _plan("port", topo, label, group).validate()


# -- fabrics without a limited switch: the reference's plans to the bit -----

UNLIMITED = {
    "ring8": lambda t: t.ring(8, bidirectional=True),
    "mesh34": lambda t: t.mesh2d(3, 4),
    "torus33": lambda t: t.torus2d(3, 3),
    "hypercube3": lambda t: t.hypercube(3),
    "multi_pod224": lambda t: t.multi_pod(2, 2, 4, unit_links=True),
    "star6": lambda t: t.star_switch(6),
    "star6_serial": lambda t: t.star_switch(6, multicast=False),
    "two2x4": lambda t: t.two_level_switch(2, npus_per_node=4),
}


@pytest.mark.parametrize("label", list(KINDS))
@pytest.mark.parametrize("fabric", list(UNLIMITED))
def test_unlimited_fabrics_equal_reference(fabric, label):
    ref, port = (_plan(pkg, UNLIMITED[fabric](PKGS[pkg][1]), label) for pkg in PKGS)
    assert not port.topology.csr().limited_switches
    for col in COLUMNS:
        x, y = getattr(ref.columns, col), getattr(port.columns, col)
        assert x.dtype == y.dtype and np.array_equal(x, y), col
    assert ref.makespan == port.makespan and ref.name == port.name
    assert ref.phase_spans == port.phase_spans


# -- the waves and the flat fallback ----------------------------------------

def test_all_reduce_waves_hold_the_buffer():
    """An All-Reduce holds each chunk in the star's switch from its
    reduction to its gather: with 8 chunks and a buffer of 2 the two-phase
    plan cannot fit, and the copy runs it in waves of two chunks."""
    alg = _grid_plan("port", "star8_b2-all_reduce")
    names = [name for name, _, _ in alg.phase_spans]
    assert names == [f"{p}{k}" for k in range(4) for p in ("reduce_scatter", "all_gather")]
    assert chip_smoke.switch_peaks(alg) == {8: 2}
    ends = {name: hi for name, _, hi in alg.phase_spans}
    starts = {name: lo for name, lo, _ in alg.phase_spans}
    for k in range(1, 4):
        assert starts[f"reduce_scatter{k}"] >= ends[f"all_gather{k - 1}"]


def test_hierarchical_plan_that_overfills_goes_flat():
    """On two_level_switch(2, 4) with a buffer of one the gateway switches
    hold chunks between the hierarchical phases; the auto route gives the
    flat plan instead; a pinned hierarchical route is kept as asked."""
    topo = ptopo.two_level_switch(2, npus_per_node=4, buffer_limit=1)
    req = pcore.CollectiveRequest("all_gather", group=tuple(range(8)))
    alg = pcore.SynthesisEngine(topo).collective(req)
    alg.validate()
    assert not alg.name.startswith("pccl_hier")
    # the gap left open: a pinned route keeps the hierarchical plan, whose
    # gateway switches the reference and the copy both overfill
    pinned = pcore.CollectiveRequest("all_gather", group=tuple(range(8)), hierarchy="always")
    hier = pcore.SynthesisEngine(topo).collective(pinned)
    assert hier.name.startswith("pccl_hier")
    with pytest.raises(AssertionError, match="buffer exceeded"):
        hier.validate()


# -- path-finding scratch per thread ----------------------------------------

def test_scratch_is_per_thread():
    topo = ptopo.mesh2d(3, 3)
    mine = pathfinding._scratch_for(topo)
    assert pathfinding._scratch_for(topo) is mine
    other = []
    th = threading.Thread(target=lambda: other.append(pathfinding._scratch_for(topo)))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and other and other[0] is not mine
    topo.add_npus(1)  # a mutated fabric drops every thread's scratch
    assert not hasattr(topo, "_bfs_scratch")
    assert len(pathfinding._scratch_for(topo).vis_t) == topo.num_nodes


def _threaded_plans(topo, jobs, n_threads=4, rounds=3, join_s=60.0):
    """Every thread runs every job ``rounds`` times on the one shared
    ``topo``; returns (threads still running after the join timeout,
    errors, {job: [plans]})."""
    plans = {job: [] for job in jobs}
    errors = []

    def work():
        try:
            for _ in range(rounds):
                for job, fn in jobs.items():
                    plans[job].append(fn(topo))
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, daemon=True) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=join_s)
    finally:
        sys.setswitchinterval(old)
    return [th for th in threads if th.is_alive()], errors, plans


@pytest.mark.parametrize("fabric", ["star8_b2", "mesh33"])
def test_threads_share_a_topology(fabric):
    """Four threads synthesize on one topology object, each through its
    own engine, and every plan equals the single-thread plan."""
    make = {"star8_b2": lambda: ptopo.star_switch(8, buffer_limit=2),
            "mesh33": lambda: ptopo.mesh2d(3, 3)}[fabric]
    jobs = {
        "all_to_all": lambda t: pcore.synthesize_all_to_all(t, list(t.npus)),
        "all_gather": lambda t: pcore.synthesize_all_gather(t, list(t.npus)),
        "all_reduce": lambda t: pcore.synthesize_all_reduce(t, list(t.npus)),
    }
    want = {job: fn(make()) for job, fn in jobs.items()}
    alive, errors, plans = _threaded_plans(make(), jobs)
    assert not alive, "threads still searching after the join timeout"
    assert not errors, errors
    for job, got in plans.items():
        assert len(got) == 12
        for alg in got:
            alg.validate()
            for col in COLUMNS:
                assert np.array_equal(getattr(alg.columns, col),
                                      getattr(want[job].columns, col)), (job, col)
