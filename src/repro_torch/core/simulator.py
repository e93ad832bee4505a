"""alpha-beta store-and-forward network simulator (ASTRA-sim-lite).

The paper evaluates synthesized algorithms in ASTRA-sim (§5.1). We reproduce
the relevant behavior with a per-link FIFO queuing simulator: chunks follow
fixed hop-by-hop routes; each directed link serves one chunk at a time with
service time alpha + bytes*beta; a chunk becomes ready at hop k+1 when its
hop-k transfer completes (store-and-forward).

PCCL-synthesized algorithms are already fully timed and congestion-free, so
"simulating" them is a replay; the simulator's queuing model is what gives
the *baseline* (Direct / logical-ring) algorithms their contention behavior
— the effect the paper's Figures 13/14/16-19 measure.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field

from repro_torch.core.algorithm import CollectiveAlgorithm, Transfer
from repro_torch.topology.topology import Topology


@dataclass
class Flow:
    """One chunk's demand: bytes moved along `route` (list of link ids)."""

    chunk: int
    bytes: float
    route: list[int]
    release: float = 0.0


@dataclass
class SimResult:
    makespan: float
    completion: dict[int, float]  # chunk -> arrival at final dest
    link_busy: dict[int, float]  # link -> total busy time
    transfers: list[Transfer] = field(default_factory=list)

    def link_utilization(self) -> dict[int, float]:
        span = self.makespan or 1.0
        return {l: b / span for l, b in self.link_busy.items()}

    def busy_timeline(self, num_links: int, bins: int = 50) -> list[float]:
        """Fraction of links busy per time bin (paper Fig. 18)."""
        if not self.transfers or self.makespan <= 0:
            return [0.0] * bins
        width = self.makespan / bins
        busy = [0.0] * bins
        for t in self.transfers:
            # clamp both ends: a transfer starting exactly at the makespan
            # (e.g. a replayed schedule whose last transfer has zero slack)
            # would otherwise index bin `bins`
            b0 = min(int(t.start / width), bins - 1)
            b1 = min(int((t.end - 1e-12) / width), bins - 1)
            for b in range(b0, b1 + 1):
                lo = max(t.start, b * width)
                hi = min(t.end, (b + 1) * width)
                busy[b] += max(0.0, hi - lo)
        return [x / (width * num_links) for x in busy]


def simulate_flows(topo: Topology, flows: list[Flow]) -> SimResult:
    """Event-driven FIFO queuing over directed links."""
    link_free = [0.0] * topo.num_links
    link_busy: dict[int, float] = defaultdict(float)
    completion: dict[int, float] = {}
    transfers: list[Transfer] = []
    # (ready_time, seq, flow_index, hop_index)
    heap: list[tuple[float, int, int, int]] = []
    seq = 0
    for fi, f in enumerate(flows):
        heapq.heappush(heap, (f.release, seq, fi, 0))
        seq += 1
    while heap:
        ready, _, fi, hop = heapq.heappop(heap)
        f = flows[fi]
        if hop >= len(f.route):
            completion[f.chunk] = ready
            continue
        link = topo.links[f.route[hop]]
        start = max(ready, link_free[link.id])
        if start > ready:
            # another chunk may become ready before this one can start;
            # requeue at the link's free time to preserve FIFO-by-ready-time.
            heapq.heappush(heap, (start, seq, fi, hop))
            seq += 1
            continue
        dur = link.transfer_time(f.bytes)
        end = start + dur
        link_free[link.id] = end
        link_busy[link.id] += dur
        transfers.append(Transfer(f.chunk, link.id, link.src, link.dst, start, end))
        heapq.heappush(heap, (end, seq, fi, hop + 1))
        seq += 1
    makespan = max(completion.values(), default=0.0)
    return SimResult(makespan, completion, dict(link_busy), transfers)


def replay_algorithm(alg: CollectiveAlgorithm) -> SimResult:
    """A synthesized schedule is already timed; replay it into a SimResult."""
    completion: dict[int, float] = {}
    for t in alg.transfers:
        completion[t.chunk] = max(completion.get(t.chunk, 0.0), t.end)
    return SimResult(
        alg.makespan, completion, alg.link_busy_time(), list(alg.transfers)
    )


def phase_breakdown(alg: CollectiveAlgorithm) -> dict[str, dict[str, float]]:
    """Per-phase timing of a composed (hierarchical / PhasePlan) algorithm:
    ``{phase: {"start", "end", "span"}}`` from the algorithm's recorded
    ``phase_spans`` — e.g. how much of a hierarchical All-to-All's makespan
    the inter-pod phase accounts for. Multi-level compositions contribute
    nested ``"parent/child"`` keys whose windows lie inside the parent's
    (filter with ``alg.top_phase_spans()`` for the top level only). Empty
    for single-phase algorithms."""
    return {
        name: {"start": lo, "end": hi, "span": hi - lo}
        for name, lo, hi in getattr(alg, "phase_spans", [])
    }


def collective_bandwidth(
    result: SimResult, payload_bytes: float
) -> float:
    """Algorithmic bandwidth: useful collective payload / completion time."""
    return payload_bytes / result.makespan if result.makespan > 0 else float("inf")
