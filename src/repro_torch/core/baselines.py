"""Baseline (topology-unaware) collective algorithms, as deployed CCLs use
today (paper §5.2): Direct pairwise send-receive for All-to-All, and logical
Ring algorithms for All-Gather / Reduce-Scatter / All-Reduce.

Baselines route each logical transfer along the static shortest path and are
evaluated under the queuing simulator — they have no global schedule, so they
congest (paper Fig. 17's "Direct" heat map) and never use links outside the
process group's shortest paths.
"""

from __future__ import annotations

import heapq

from repro_torch.core.conditions import ChunkIds, all_gather, all_to_all
from repro_torch.core.simulator import Flow, SimResult, simulate_flows
from repro_torch.topology.topology import Topology


def shortest_path_links(topo: Topology, src: int, dst: int,
                        chunk_bytes: float = 1.0) -> list[int]:
    """Deterministic alpha-beta-weighted shortest path, as a list of link ids."""
    dist = [float("inf")] * topo.num_nodes
    pred: dict[int, tuple[int, int]] = {}
    dist[src] = 0.0
    heap = [(0.0, src)]
    while heap:
        du, u = heapq.heappop(heap)
        if u == dst:
            break
        if du > dist[u]:
            continue
        for link in topo.out_links(u):
            alt = du + link.transfer_time(chunk_bytes)
            v = link.dst
            if alt < dist[v] - 1e-12 or (
                abs(alt - dist[v]) <= 1e-12 and (v not in pred or link.id < pred[v][1])
            ):
                dist[v] = alt
                pred[v] = (u, link.id)
                heapq.heappush(heap, (alt, v))
    if dist[dst] == float("inf"):
        raise AssertionError(f"no route {src} -> {dst}")
    route: list[int] = []
    node = dst
    while node != src:
        u, link_id = pred[node]
        route.append(link_id)
        node = u
    return list(reversed(route))


def direct_all_to_all(
    topo: Topology,
    group: list[int],
    *,
    bytes: float = 1.0,
    chunks_per_pair: int = 1,
    ids: ChunkIds | None = None,
) -> SimResult:
    """Direct (pairwise point-to-point) All-to-All over shortest paths —
    what CCLs implement today (paper §3.3, §5.2)."""
    conds = all_to_all(list(group), ids=ids or ChunkIds(), bytes=bytes,
                       chunks_per_pair=chunks_per_pair)
    flows = [
        Flow(c.chunk, c.bytes,
             shortest_path_links(topo, c.src, next(iter(c.dests)), c.bytes))
        for c in conds
    ]
    return simulate_flows(topo, flows)


def ring_all_gather(
    topo: Topology,
    group: list[int],
    *,
    bytes: float = 1.0,
    ids: ChunkIds | None = None,
) -> SimResult:
    """Topology-unaware logical Ring All-Gather (paper Fig. 3b): chunk i makes
    n-1 logical hops around `group` order; each logical hop rides the physical
    shortest path."""
    group = list(group)
    n = len(group)
    conds = all_gather(group, ids=ids or ChunkIds(), bytes=bytes)
    hop_routes = [
        shortest_path_links(topo, group[i], group[(i + 1) % n], bytes)
        for i in range(n)
    ]
    flows = []
    for idx, c in enumerate(conds):
        # chunk originating at group[idx] travels idx -> idx+1 -> ... (n-1 hops)
        route: list[int] = []
        for k in range(n - 1):
            route.extend(hop_routes[(idx + k) % n])
        flows.append(Flow(c.chunk, c.bytes, route))
    return simulate_flows(topo, flows)


def direct_all_gather(
    topo: Topology,
    group: list[int],
    *,
    bytes: float = 1.0,
    ids: ChunkIds | None = None,
) -> SimResult:
    """Each NPU unicasts its chunk to every peer over shortest paths."""
    group = list(group)
    flows = []
    idgen = ids or ChunkIds()
    for src in group:
        for dst in group:
            if src == dst:
                continue
            flows.append(
                Flow(idgen.next(), bytes, shortest_path_links(topo, src, dst, bytes))
            )
    return simulate_flows(topo, flows)
