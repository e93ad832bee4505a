"""Back-compat synthesis front-ends (paper §4.4, Algorithm 3; §4.5 Fig. 8).

The synthesis loop itself lives in :class:`repro.core.engine.SynthesisEngine`,
which owns TEN lifecycle, int/cont mode selection, condition ordering, and
commit — and can route named collectives through an
:class:`repro.core.registry.AlgorithmRegistry` so isomorphic process groups
share one cached plan. The ``synthesize*`` functions below are thin wrappers
that build a throwaway engine per call; they keep every historical signature
working. Pass ``registry=`` to opt into caching from these wrappers too.
"""

from __future__ import annotations

from repro_torch.core.algorithm import CollectiveAlgorithm
from repro_torch.core.conditions import ChunkIds, Condition
from repro_torch.core.engine import SynthesisEngine, order_conditions
from repro_torch.core.request import CollectiveRequest
from repro_torch.topology.topology import Topology

__all__ = [
    "order_conditions",
    "synthesize",
    "synthesize_all_gather",
    "synthesize_all_reduce",
    "synthesize_all_to_all",
    "synthesize_joint",
    "synthesize_reduce",
    "synthesize_reduce_scatter",
]


def synthesize(
    topo: Topology,
    conds: list[Condition],
    *,
    preload: CollectiveAlgorithm | None = None,
    mode: str = "auto",
    name: str = "pccl",
) -> CollectiveAlgorithm:
    """Paper Algorithm 3. `preload`'s transfers are committed into the TEN
    first (used to compose All-Reduce phases without link conflicts)."""
    return SynthesisEngine(topo).synthesize(
        conds, preload=preload, mode=mode, name=name
    )


def synthesize_all_gather(topo, group, *, bytes=1.0, chunks_per_npu=1,
                          ids=None, registry=None, hierarchy="auto"):
    req = CollectiveRequest("all_gather", group=tuple(group), bytes=bytes,
                            chunks=chunks_per_npu, hierarchy=hierarchy)
    return SynthesisEngine(topo, registry=registry).collective(req, ids=ids)


def synthesize_all_to_all(topo, group, *, bytes=1.0, chunks_per_pair=1,
                          ids=None, registry=None, hierarchy="auto"):
    req = CollectiveRequest("all_to_all", group=tuple(group), bytes=bytes,
                            chunks=chunks_per_pair, hierarchy=hierarchy)
    return SynthesisEngine(topo, registry=registry).collective(req, ids=ids)


def synthesize_reduce(
    topo: Topology, group: list[int], root: int, *,
    bytes: float = 1.0, ids: ChunkIds | None = None, registry=None,
) -> CollectiveAlgorithm:
    req = CollectiveRequest("reduce", group=tuple(group), root=root,
                            bytes=bytes)
    return SynthesisEngine(topo, registry=registry).collective(req, ids=ids)


def synthesize_reduce_scatter(
    topo: Topology, group: list[int], *,
    bytes: float = 1.0, chunks_per_npu: int = 1, ids: ChunkIds | None = None,
    registry=None, hierarchy: str = "auto",
) -> CollectiveAlgorithm:
    req = CollectiveRequest("reduce_scatter", group=tuple(group),
                            bytes=bytes, chunks=chunks_per_npu,
                            hierarchy=hierarchy)
    return SynthesisEngine(topo, registry=registry).collective(req, ids=ids)


def synthesize_all_reduce(
    topo: Topology, group: list[int], *,
    bytes: float = 1.0, ids: ChunkIds | None = None, pipelined: bool = False,
    registry=None, hierarchy: str = "auto",
) -> CollectiveAlgorithm:
    req = CollectiveRequest("all_reduce", group=tuple(group), bytes=bytes,
                            pipelined=pipelined, hierarchy=hierarchy)
    return SynthesisEngine(topo, registry=registry).collective(req, ids=ids)


def synthesize_joint(
    topo: Topology,
    groups: list[tuple[str, list[Condition]]],
    *,
    name: str = "pccl_joint",
) -> CollectiveAlgorithm:
    """Jointly synthesize several process groups' collectives over one shared
    TEN (paper §6.4, Fig. 15). Chunk ids across groups must be unique — use a
    shared ChunkIds allocator."""
    return SynthesisEngine(topo).synthesize_joint(groups, name=name)
