"""The port's planner copy (``repro_torch.core``, ``repro_torch.topology``)
against the reference (``repro.core``, ``repro.topology``): the same
fabrics, the same requests, the same plans to the bit.

Both packages are numpy-only here, so every case runs both side by side.
The copy is a copy (``tests/test_torch_port_rules.py`` holds its text to the
reference's), so the plans must be equal, not merely both valid: the seven
transfer columns, ``validate()``, and the translated rounds with their
digest. One pinned case is a fault of the reference that the copy inherits
(a switch with a buffer of one is oversubscribed); it is pinned, not skipped.
"""

import warnings

import numpy as np
import pytest

import repro.core as rcore
import repro.topology as rtopo
from repro.core.engine import SynthesisEngine as RefEngine
from repro.core.registry import AlgorithmRegistry as RefRegistry
from repro.core.registry import topology_fingerprint as ref_fingerprint
from repro.core.translate import to_ppermute_program as ref_translate
from repro.topology.generators import grid_hypercube as ref_grid
from repro.topology.generators import multi_pod as ref_multi_pod

import repro_torch.core as pcore
import repro_torch.topology as ptopo
from repro_torch.core.engine import SynthesisEngine as PortEngine
from repro_torch.core.registry import AlgorithmRegistry as PortRegistry
from repro_torch.core.registry import topology_fingerprint as port_fingerprint
from repro_torch.core.translate import to_ppermute_program as port_translate
from repro_torch.topology.generators import grid_hypercube as port_grid
from repro_torch.topology.generators import multi_pod as port_multi_pod

PKGS = {
    "ref": dict(topo=rtopo, grid=ref_grid, multi_pod=ref_multi_pod, core=rcore,
                engine=RefEngine, registry=RefRegistry),
    "port": dict(topo=ptopo, grid=port_grid, multi_pod=port_multi_pod, core=pcore,
                 engine=PortEngine, registry=PortRegistry),
}

# fabric -> (builder over a package, request keywords of its route)
FABRICS = {
    "ring8": (lambda p: p["topo"].ring(8, bidirectional=True), {}),
    "line8": (lambda p: p["topo"].line(8), {}),
    "torus24": (lambda p: p["topo"].torus2d(2, 4), {}),
    "torus44": (lambda p: p["topo"].torus2d(4, 4), {}),
    "grid23": (lambda p: p["grid"](2, 3), {"hierarchy": "always"}),
    "mp222": (lambda p: p["multi_pod"](2, 2, 2, unit_links=True, dci_ports_per_pod=2),
              {"hierarchy": "always"}),
    "mp222_skew": (lambda p: p["multi_pod"](2, 2, 2, dci_port_gbps=[100.0, 10.0]),
                   {"hierarchy": "always", "gateway_strategy": "te"}),
    "star_switch": (lambda p: p["topo"].star_switch(6), {}),
}
# kind label -> (kind, extra request keywords)
KINDS = {
    "all_gather": ("all_gather", {}),
    "reduce_scatter": ("reduce_scatter", {}),
    "all_reduce": ("all_reduce", {"pipelined": False}),
    "all_reduce_pipelined": ("all_reduce", {"pipelined": True}),
    "all_to_all": ("all_to_all", {}),
}
# tests/test_exec_conformance.py's strict-subset process groups
SUBSET_CASES = [
    ("line8", (0, 3, 7)),
    ("grid23", (0, 2, 5, 6)),
    ("mp222", (1, 2, 4, 7)),
]
# BENCH_synthesis.json's fig_exec rows (benchmarks/exec_mesh.py's cases)
FIG_EXEC = {
    "ag_ring8": ("ring8", "all_gather", {"hierarchy": "never"}, 8, 56),
    "rs_ring8": ("ring8", "reduce_scatter", {"hierarchy": "never"}, 8, 56),
    "ar_hier8": ("grid23", "all_reduce", {"hierarchy": "always", "pipelined": True}, 18, 112),
    "a2a_mp8": ("mp222", "all_to_all", {"hierarchy": "always"}, 27, 96),
}
COLUMNS = ("chunk", "link", "src", "dst", "start", "end", "reduce")

_TOPOS: dict = {}


def topo(pkg: str, fabric: str):
    if (pkg, fabric) not in _TOPOS:
        _TOPOS[(pkg, fabric)] = FABRICS[fabric][0](PKGS[pkg])
    return _TOPOS[(pkg, fabric)]


def synthesize(pkg: str, fabric: str, kind: str, group, **kw):
    """One fresh engine with its own registry per call: no state is shared
    between the packages or between cases."""
    p = PKGS[pkg]
    t = topo(pkg, fabric)
    req = p["core"].CollectiveRequest(kind, group=tuple(group), **kw)
    return p["engine"](t, registry=p["registry"]()).collective(req)


def assert_same_plan(fabric, kind, group, **kw):
    """Equal transfer columns, both valid, equal rounds and digest."""
    ref = synthesize("ref", fabric, kind, group, **kw)
    port = synthesize("port", fabric, kind, group, **kw)
    for col in COLUMNS:
        a, b = getattr(ref.columns, col), getattr(port.columns, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"column {col} differs"
    ref.validate()
    port.validate()
    rp, pp = ref_translate(ref), port_translate(port)
    assert rp.num_devices == pp.num_devices
    assert [[(s.src, s.dst, s.chunk, s.reduce) for s in r] for r in rp.rounds] == \
        [[(s.src, s.dst, s.chunk, s.reduce) for s in r] for r in pp.rounds]
    assert rp.chunk_holders == pp.chunk_holders
    assert rp.chunk_dests == pp.chunk_dests
    assert rp.digest() == pp.digest()
    return rp, pp


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_topology_copy(fabric):
    ref, port = topo("ref", fabric), topo("port", fabric)
    assert ref_fingerprint(ref) == port_fingerprint(port)
    assert [(l.id, l.src, l.dst, l.alpha, l.beta) for l in ref.links] == \
        [(l.id, l.src, l.dst, l.alpha, l.beta) for l in port.links]
    assert ref.npus == port.npus
    assert [ref.is_switch(v) for v in range(ref.num_nodes)] == \
        [port.is_switch(v) for v in range(port.num_nodes)]


@pytest.mark.parametrize("label", sorted(KINDS))
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_full_group_plans_equal(fabric, label):
    kind, kw = KINDS[label]
    assert_same_plan(fabric, kind, topo("ref", fabric).npus,
                     **FABRICS[fabric][1], **kw)


@pytest.mark.parametrize("label", sorted(KINDS))
@pytest.mark.parametrize("case", range(len(SUBSET_CASES)),
                         ids=[c[0] for c in SUBSET_CASES])
def test_subset_group_plans_equal(case, label):
    fabric, group = SUBSET_CASES[case]
    kind, kw = KINDS[label]
    assert_same_plan(fabric, kind, group, **FABRICS[fabric][1], **kw)


@pytest.mark.parametrize("tag", sorted(FIG_EXEC))
def test_fig_exec_counts(tag):
    """The rounds and sends of the fig_exec rows, in both packages."""
    fabric, kind, kw, rounds, sends = FIG_EXEC[tag]
    rp, pp = assert_same_plan(fabric, kind, range(8), **kw)
    assert (pp.num_rounds, pp.num_sends) == (rounds, sends)
    assert (rp.num_rounds, rp.num_sends) == (rounds, sends)


@pytest.mark.parametrize("kind", ["all_gather", "all_to_all"])
def test_te_gateway_strategy_routes_differently(kind):
    """On skewed DCI uplinks the TE gateway assignment keeps traffic off the
    slow uplink, where round-robin does not: another plan with a shorter
    makespan, equal in both packages either way."""
    group = range(8)
    plans = {}
    for strategy in ("round_robin", "te"):
        assert_same_plan("mp222_skew", kind, group, hierarchy="always",
                         gateway_strategy=strategy)
        plans[strategy] = synthesize("port", "mp222_skew", kind, group,
                                     hierarchy="always", gateway_strategy=strategy)
    assert not np.array_equal(plans["te"].columns.link, plans["round_robin"].columns.link)
    assert plans["te"].makespan < plans["round_robin"].makespan


@pytest.mark.parametrize("kw", [
    dict(kind="all_gather", group=(0, 1, 2)),
    dict(kind="all_reduce", group=(3, 1, 2, 0), pipelined=True, bytes=4.0),
    dict(kind="all_to_all", group=(0, 5), chunks=2, hierarchy="always"),
    dict(kind="reduce", group=(0, 1, 2), root=1),
    dict(kind="all_gather", group=(0, 1), gateway_strategy="te"),
])
def test_request_fingerprint_equal(kw):
    ref = rcore.CollectiveRequest(**kw)
    port = pcore.CollectiveRequest(**kw)
    assert ref.fingerprint() == port.fingerprint()


def test_copy_collective_path_raises_no_deprecation():
    """The copy's PCCLDeprecationWarning is a class of its own, which the
    pytest settings do not escalate: its call sites use the request API."""
    from repro_torch.comms import primitives

    with warnings.catch_warnings():
        warnings.simplefilter("error", pcore.PCCLDeprecationWarning)
        primitives._PROGRAM_CACHE.clear()
        for kind in ("all_gather", "reduce_scatter", "all_reduce", "all_to_all"):
            primitives.synthesize_program(
                topo("port", "grid23"),
                pcore.CollectiveRequest(kind, group=tuple(range(8)), hierarchy="always"),
                registry=PortRegistry())
    assert pcore.PCCLDeprecationWarning is not rcore.PCCLDeprecationWarning


def _switch_draw(pkg: str):
    """test_core_property.py::test_switch_random_topology's failing draw:
    unit links on the ring 4->3->5->1->2->0->4 and one switch (node 6),
    buffer of one chunk, no multicast, linked both ways to NPUs 0, 3, 5."""
    tt = PKGS[pkg]["topo"]
    t = tt.Topology("prop")
    t.add_npus(6)
    ring = [4, 3, 5, 1, 2, 0]
    for i in range(6):
        t.add_link(ring[i], ring[(i + 1) % 6], 0.0, 1.0)
    sw = t.add_node(tt.NodeType.SWITCH, buffer_limit=1, multicast=False)
    for m in (0, 3, 5):
        t.add_bidir_link(m, sw, 0.0, 1.0)
    return t


def test_switch_buffer_fault_pinned():
    """A fault of the reference, inherited by the copy: synthesis returns a
    plan that oversubscribes the one-chunk switch buffer, and validate()
    rejects it. Both packages give the same plan and the same error."""
    algs = {}
    for pkg, p in PKGS.items():
        engine = p["engine"](_switch_draw(pkg))
        algs[pkg] = engine.synthesize(p["core"].all_gather([3, 5, 4, 0, 1]))
    for col in COLUMNS:
        assert np.array_equal(getattr(algs["ref"].columns, col),
                              getattr(algs["port"].columns, col))
    errors = []
    for alg in algs.values():
        with pytest.raises(AssertionError, match=r"switch 6 buffer exceeded \(2 > 1\)") as e:
            alg.validate()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _disk_race(pkg: str, cache_dir, iters=12):
    """Two writer threads and one reader thread share one cache directory
    whose size cap keeps about one plan, so every store evicts another.
    Each thread has its own topology object (the engines' path-finding
    scratch lives on the topology and is not shared across threads).
    Returns the errors the threads met."""
    import sys
    import threading

    p = PKGS[pkg]
    registry_cls, engine_cls = p["registry"], p["engine"]
    request_cls = p["core"].CollectiveRequest
    probe = registry_cls(cache_dir=str(cache_dir / "probe"))
    engine_cls(FABRICS["ring8"][0](p), registry=probe).collective(
        request_cls("all_gather", group=tuple(range(8)), bytes=1.0))
    cap = int(probe.stats.bytes_stored * 1.5)
    errors: list = []

    def run(role: int) -> None:
        topo_ = FABRICS["ring8"][0](p)
        try:
            for i in range(iters):
                reg = registry_cls(cache_dir=str(cache_dir / "shared"), max_disk_bytes=cap)
                nbytes = float(1 + (i + role) % 3) if role < 2 else float(1 + i % 3)
                alg = engine_cls(topo_, registry=reg).collective(
                    request_cls("all_gather", group=tuple(range(8)), bytes=nbytes))
                alg.validate()
        except Exception as e:  # noqa: BLE001 - every failure is the finding
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(role,)) for role in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often, inside the store too
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_store_disk_two_writers_one_reader(tmp_path):
    """The copy's fix of the reference's _store_disk race: the temporary
    name is unique per thread, and the size comes from it before the
    rename, so a writer whose entry another evicts at once does not fail."""
    errors = _disk_race("port", tmp_path)
    assert errors == []
    assert list((tmp_path / "shared").glob("*.npz"))
    assert not list((tmp_path / "shared").glob("*.tmp.*"))
