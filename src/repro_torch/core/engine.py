"""SynthesisEngine: the single owner of the PCCL synthesis loop.

Historically every ``synthesize*`` front-end in :mod:`repro.core.synthesizer`
re-implemented the same lifecycle: build a TEN, pick int/cont mode, order
conditions, run BFS per condition, commit the pruned paths. The engine owns
that lifecycle in one place (paper §4.4, Algorithm 3) and adds two things the
front-ends could not:

* a per-topology distance cache shared across calls (condition ordering no
  longer recomputes shortest paths for every collective on the same fabric);
* an optional :class:`repro.core.registry.AlgorithmRegistry` hook — named
  collectives (all_gather, all_to_all, reductions) are fetched through the
  registry so isomorphic process groups reuse one synthesized, canonicalized
  plan instead of redoing the TEN/BFS work.

The ``synthesize*`` functions in ``synthesizer.py`` remain as thin wrappers
for backward compatibility; new code should hold a ``SynthesisEngine``.
"""

from __future__ import annotations

import heapq
import warnings
from dataclasses import dataclass, replace
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import conditions as cnd
from repro_torch.core.algorithm import (CollectiveAlgorithm, Transfer,
                                  TransferColumns)
from repro_torch.core.conditions import ChunkIds, Condition, ReduceCondition
from repro_torch.core.pathfinding import PathResult, bfs_cont, bfs_int
from repro_torch.core.registry import renumber_chunks
from repro_torch.core.request import (_UNSET, CollectiveRequest,
                                PCCLDeprecationWarning)
from repro_torch.core.ten import TEN
from repro_torch.topology.topology import Topology


# ---------------------------------------------------------------------------
# Phase composition (generalizes the old ad-hoc ``preload`` hack)
# ---------------------------------------------------------------------------

@dataclass
class PhaseSpec:
    """One phase of a composed synthesis, on one global clock.

    A phase either carries ``conds`` to synthesize (releases are absolute
    times — ``after``/``start`` only raise them) or a pre-synthesized
    ``algorithm`` whose transfers are already absolutely timed. Phases may
    run on a sub-topology: ``node_map``/``link_map`` translate local ids
    back into the composing engine's fabric (see
    :meth:`repro.topology.topology.Topology.pod_subtopology`), and
    ``chunk_map`` renumbers phase-local chunk ids into the final
    condition set's ids.

    ``preload_from`` names earlier phases on the *same* topology object
    whose transfers are committed into this phase's TEN before searching, so
    time-overlapping phases stay congestion-free — the mechanism behind
    pipelined All-Reduce and pipelined hierarchical scatter phases.

    Floors come in two granularities. ``after``/``start`` derive one scalar
    floor for the whole phase (the classic barrier). ``floors_from`` /
    ``floors`` instead derive a *per-chunk* floor vector: each condition's
    release is raised to its own chunk's floor — ``floors_from`` names
    earlier phases whose per-chunk completion times (max transfer end per
    global chunk id, the packed ``np.unique`` + ``maximum.at`` reduction)
    become the vector, ``floors`` supplies explicit global-chunk-id ->
    absolute-time entries. This is what lets a composed All-Reduce release
    each chunk's gather at that chunk's own reduce completion instead of
    the phase barrier. Per-chunk floors only ever *raise* releases, and
    they apply to ``conds`` phases only: a pre-synthesized ``algorithm``
    is one congestion-free block — shifting its chunks by different
    amounts could overlap transfers on a shared link, so chunk-granular
    phases must be (re-)synthesized with the floors in their conditions.
    """

    name: str
    conds: list[Condition] | None = None
    algorithm: CollectiveAlgorithm | None = None
    topology: Topology | None = None  # None = the engine's fabric
    node_map: Sequence[int] | None = None  # local node -> global node
    link_map: Sequence[int] | None = None  # local link -> global link
    chunk_map: dict[int, int] | None = None  # local chunk -> global chunk
    after: tuple[str, ...] = ()  # release floor: ends of these phases
    start: float = 0.0  # extra absolute release floor
    preload_from: tuple[str, ...] = ()
    mode: str = "auto"
    replicate: bool = False  # enable the path-replication fast path
    floors_from: tuple[str, ...] = ()  # per-chunk floors: deps' done-times
    floors: dict[int, float] | None = None  # global chunk -> absolute floor


@dataclass
class PhasePlan:
    """Ordered phases + the overall conditions the stitched result fulfils."""

    phases: list[PhaseSpec]
    conditions: list  # list[Condition | ReduceCondition]
    name: str = "pccl_phased"


# ---------------------------------------------------------------------------
# Time reversal (paper §4.5, Fig. 8)
# ---------------------------------------------------------------------------

def time_reversed(
    forward_topo: Topology,
    alg: CollectiveAlgorithm,
    reduce_conds: list,
    *,
    name: str | None = None,
) -> CollectiveAlgorithm:
    """Reverse a (broadcast/all-gather style) algorithm synthesized on the
    reversed topology into a reduction algorithm on the forward topology.

    Link k of ``reversed(topo)`` is link k of ``topo`` with endpoints swapped
    (by construction), so link ids carry over directly. A transfer at [s, e)
    maps to [T - e, T - s): out-trees become in-trees and causality is
    preserved (child partials arrive before the parent forwards its own
    partial). Phase provenance is carried over with spans mirrored into the
    reversed clock and re-sorted into execution order — the scatter phases
    of a hierarchical broadcast become the leaf reduce phases of the
    reduction. Nested spans (``"parent/child"`` entries from multi-level
    composition) mirror the same way; sorting by mirrored start keeps
    parents adjacent to their children even though a parent's window
    contains its children's.
    """
    cols = alg.columns
    T = float(cols.end.max()) if len(cols) else 0.0
    # the reversed schedule starts no earlier than the *latest* release
    # among the reduce conditions: with uniform releases max == min (the
    # historical behaviour, byte-identical), while per-chunk heterogeneous
    # releases (chunk-granular phase floors) need every reversed transfer
    # to clear every condition's release bound
    base = max((c.release for c in reduce_conds), default=0.0)
    rev = cols.time_reversed(base + T)
    spans = sorted(
        ((ph, base + T - hi, base + T - lo)
         for ph, lo, hi in alg.phase_spans),
        key=lambda s: (s[1], s[2], s[0]),
    )
    # >>> copy fix: plans that overfill a switch buffer across phases
    return CollectiveAlgorithm(forward_topo, list(reduce_conds), rev,
                               name=name or alg.name, phase_spans=spans)


def _overfills(alg: CollectiveAlgorithm) -> bool:
    """True when ``alg`` holds more chunks in a limited switch than its
    buffer takes, counted as validate() counts them: one residency per
    (switch, chunk), from the chunk's first arrival to its last forward
    over the whole plan, a departure leaving before a same-instant
    arrival. Phases that meet in a switch (a reduction's gather back out
    of it, a gateway holding a chunk between two phases) make one stay of
    the chunk's two visits, which no single search sees whole."""
    topo = alg.topology
    events: dict[int, list[tuple[float, int]]] = {}
    for (sw, _), (a, d) in TEN.switch_stays(topo, alg.columns).items():
        events.setdefault(sw, []).extend(((a, 1), (d, -1)))
    for sw, evs in events.items():
        limit = topo.nodes[sw].buffer_limit
        occ = 0
        for _, delta in sorted(evs):
            occ += delta
            if occ > limit:
                return True
    return False
    # <<< copy fix


# ---------------------------------------------------------------------------
# Distances for condition ordering (Algorithm 3, lines 1-7)
# ---------------------------------------------------------------------------

class _DistanceCache:
    """Per-source shortest-path times on the static topology, cached.

    Homogeneous graphs use hop counts; heterogeneous use alpha-beta link
    times for the given chunk size (Dijkstra).
    """

    def __init__(self, topo: Topology):
        self.topo = topo
        self.homog = topo.homogeneous()
        self._cache: dict = {}

    def _hops_from(self, src: int) -> "list[float]":
        """Hop distances from one source, served from the topology's shared
        all-pairs matrix (one C-level sweep) when scipy is available."""
        topo = self.topo
        matrix = topo.hop_matrix()
        if matrix is not None:
            return matrix[src].tolist()
        dn = topo.hop_distances_np(src).astype(float)
        dn[dn < 0] = float("inf")
        return dn.tolist()

    def dist(self, src: int, chunk_bytes: float) -> list[float]:
        key = (src, None if self.homog else chunk_bytes)
        got = self._cache.get(key)
        if got is not None:
            return got
        topo = self.topo
        if self.homog:
            d = self._hops_from(src)
        else:
            d = [float("inf")] * topo.num_nodes
            d[src] = 0.0
            heap = [(0.0, src)]
            while heap:
                du, u = heapq.heappop(heap)
                if du > d[u]:
                    continue
                for link in topo.out_links(u):
                    alt = du + link.transfer_time(chunk_bytes)
                    if alt < d[link.dst]:
                        d[link.dst] = alt
                        heapq.heappush(heap, (alt, link.dst))
        self._cache[key] = d
        return d

    def condition_dist(self, c: Condition) -> float:
        d = self.dist(c.src, c.bytes)
        return max((d[dst] for dst in c.remote_dests), default=0.0)


def order_conditions(topo: Topology, conds: list[Condition]) -> list[Condition]:
    """Sort descending by max shortest-path distance (Algorithm 3 line 7);
    deterministic tie-break on (bytes, chunk id)."""
    return SynthesisEngine(topo).order_conditions(conds)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class SynthesisEngine:
    """Owns TEN lifecycle, mode selection, condition ordering, and commit.

    One engine per physical topology; cheap to construct, cheaper to reuse
    (the distance cache and the reversed-topology view persist across calls).
    Pass a ``registry`` to share synthesized plans across isomorphic process
    groups and across engines.
    """

    def __init__(self, topology: Topology, *, registry=None,
                 gateway_strategy: str = "auto", sketch=None):
        self.topology = topology
        self.registry = registry
        # inter-pod gateway selection policy and operator constraints for
        # the hierarchical route (see repro.core.hierarchy and
        # repro.core.traffic); picked up by the lazy HierarchicalSynthesizer
        self.gateway_strategy = gateway_strategy
        self.sketch = sketch
        self._distances = _DistanceCache(topology)
        self._rev_topo: Topology | None = None
        self._hier = None  # lazy HierarchicalSynthesizer
        # request-configured engine variants (gateway_strategy/sketch
        # overrides), sharing this engine's topology and registry
        self._variants: dict = {}
        # opt-in plan-capture hook (repro.core.repair): when a list, every
        # synthesize_plan() appends (plan, result) so a repairer can keep
        # the composed PhaseSpec record alongside the stitched algorithm
        self._capture: list | None = None
        # degradation fingerprint (repro.core.repair): set on engines built
        # over degraded fabric views. Folded into whole-collective registry
        # route params — on top of the degraded topology's own structure
        # hash — so a degraded plan never cross-serves a healthy fabric's
        # request or another event's. Appended only when set, keeping
        # healthy-fabric keys bit-identical to the pre-repair format.
        self.degradation: str | None = None
        # reusable per-topology state: {id(topo): (topo, TEN)} — the forward
        # and reversed views in practice. TENs are reset() per synthesis
        # instead of reallocated; distance caches persist across calls.
        self._tens: dict[int, tuple[Topology, TEN]] = {}
        self._dist_caches: dict[int, tuple[Topology, _DistanceCache]] = {
            id(topology): (topology, self._distances)
        }
        # fixed-route scheduling state: canonical (src, dest) routes (found
        # by BFS on an empty TEN, memoized). Keyed by object id but guarded
        # by identity — the entry pins (topo, empty TEN, route table), so a
        # recycled id can never serve a stale topology's routes.
        self._route_tens: dict[int, tuple[Topology, TEN, dict]] = {}

    # -- lifecycle pieces ---------------------------------------------------

    def _ten_for(self, topo: Topology) -> TEN:
        ent = self._tens.get(id(topo))
        if ent is None or ent[0] is not topo:
            ent = (topo, TEN(topo))
            self._tens[id(topo)] = ent
        ten = ent[1]
        ten.reset()
        return ten

    def _dist_cache_for(self, topo: Topology) -> _DistanceCache:
        ent = self._dist_caches.get(id(topo))
        if ent is None or ent[0] is not topo:
            ent = (topo, _DistanceCache(topo))
            self._dist_caches[id(topo)] = ent
        return ent[1]

    def order_conditions(self, conds: list[Condition]) -> list[Condition]:
        return self._order(self._distances, conds)

    @staticmethod
    def _order(cache: _DistanceCache, conds: list[Condition],
               group_runs: bool = False) -> list[Condition]:
        """Sort by (-max shortest-path distance, -bytes, chunk), stable.

        Distances come from one (cached, vectorized) pass per source; the
        composite sort key is evaluated in bulk with a numpy lexsort instead
        of a per-condition ``condition_dist`` call inside ``sorted``.

        ``group_runs`` additionally breaks distance ties by (src, dest,
        release) so identical conditions land adjacent — the precondition
        for the path-replication fast path in :meth:`synthesize`. Algorithm 3
        only prescribes the distance ordering, so tie-break choice does not
        affect correctness.

        Release-bearing condition sets (composed phases, pipelined
        All-Reduce) tie-break by ascending release before chunk id —
        schedule what is ready first; for the uniform-release sets of plain
        collectives every release is equal, so flat synthesis order is
        byte-identical to the historical one."""
        nc = len(conds)
        if nc <= 1:
            return list(conds)
        dist_key = np.empty(nc)
        bytes_key = np.empty(nc)
        chunk_key = np.empty(nc, dtype=np.int64)
        rel_key = np.empty(nc)
        if group_runs:
            src_key = np.empty(nc, dtype=np.int64)
            dest_key = np.empty(nc, dtype=np.int64)
        for k, c in enumerate(conds):
            d = cache.dist(c.src, c.bytes)
            rd = c.remote_dests
            if len(rd) == 1:
                (x,) = rd
                dist_key[k] = d[x]
            else:
                dist_key[k] = max((d[x] for x in rd), default=0.0)
            bytes_key[k] = c.bytes
            chunk_key[k] = c.chunk
            rel_key[k] = c.release
            if group_runs:
                src_key[k] = c.src
                dest_key[k] = min(c.dests)
        if group_runs:
            order = np.lexsort(
                (np.arange(nc), chunk_key, rel_key, dest_key, src_key,
                 -bytes_key, -dist_key)
            )
        else:
            order = np.lexsort(
                (np.arange(nc), chunk_key, rel_key, -bytes_key, -dist_key)
            )
        return [conds[k] for k in order]

    def _use_int_mode(self, conds: list[Condition],
                      topo: Topology | None = None) -> bool:
        topo = topo or self.topology
        if not topo.homogeneous() or not conds:
            return False
        b0 = conds[0].bytes
        if any(c.bytes != b0 for c in conds):
            return False
        if any(c.release != int(c.release) for c in conds):
            return False
        # unit transfer time required for the integer TEN
        link = topo.links[0] if topo.links else None
        return link is None or link.transfer_time(b0) == 1.0

    @staticmethod
    def _fast_int_commit(topo: Topology, int_mode: bool) -> bool:
        """True when the commit needs no switch bookkeeping (the single
        predicate behind both the per-call hoist in ``synthesize`` and the
        fallback in ``_commit``). Switch residency intervals exist solely to
        enforce buffer limits during later searches, so unlimited-buffer
        switches (the common DCI/spine case) take the bulk path too —
        emitted schedules are unchanged, only dead bookkeeping is skipped."""
        if not int_mode:
            return False
        csr = topo.csr()
        return not csr.any_switch or not csr.limited_switches

    def _commit(self, ten: TEN, result: PathResult, int_mode: bool) -> None:
        # occupy links of retained paths only (paper Fig. 6e / Fig. 7)
        topo = ten.topology
        if self._fast_int_commit(topo, int_mode):
            ten.commit_int_many(result.transfers)
            return
        last_send_end: dict[int, float] = {}
        for t in result.transfers:
            if int_mode:
                ten.commit_int(t.link, int(t.start))
            else:
                ten.commit(t.link, t.start, t.end)
            if topo.is_switch(t.src):
                last_send_end[t.src] = max(last_send_end.get(t.src, 0.0), t.end)
        # switch residency: arrival .. last retained forward
        for t in result.transfers:
            if topo.is_switch(t.dst):
                ten.commit_residency(
                    t.dst, t.end, max(last_send_end.get(t.dst, t.end), t.end)
                )

    def reversed_topology(self) -> Topology:
        """The link-reversed view used for reduction synthesis, built once."""
        if self._rev_topo is None:
            self._rev_topo = self.topology.reversed()
        return self._rev_topo

    # -- Algorithm 3 --------------------------------------------------------

    def synthesize(
        self,
        conds: list[Condition],
        *,
        preload: CollectiveAlgorithm | None = None,
        mode: str = "auto",
        name: str = "pccl",
        topology: Topology | None = None,
        replicate: bool = False,
    ) -> CollectiveAlgorithm:
        """Paper Algorithm 3 over a fresh TEN. ``preload``'s transfers are
        committed first (used to compose All-Reduce phases without link
        conflicts). ``topology`` overrides the engine's topology for internal
        reversed-topology passes.

        ``replicate=True`` enables the bulk-traffic fast paths, active only
        in integer mode on fabrics where link occupancy is the sole
        constraint (no buffer-limited and no serial switches):

        * single-destination conditions take *fixed-route scheduling* — the
          (src, dest) route is searched once on an empty TEN and memoized;
          every chunk then rides it with per-hop earliest-free waits. Bulk
          flows wait in queue instead of detouring, which keeps transfer
          counts at the hop-distance minimum (an earliest-arrival search
          under deep congestion detours, and a thousand-chunk run would
          replicate the detour a thousand times).
        * runs of identical multi-destination conditions reuse the first
          instance's searched tree shifted to the next free time slots,
          falling back to a full search when shifting fails.

        Schedules stay valid by construction (the oracle re-checks
        everything) and the default-off flag keeps flat synthesis
        byte-stable."""
        topo = topology or self.topology
        ten = self._ten_for(topo)
        int_mode = mode == "int" or (
            mode == "auto" and self._use_int_mode(conds, topo)
        )
        # >>> copy fix: the switch residencies of preloaded phases
        # An earlier phase's chunks stay in limited switch buffers too: this
        # phase's searches count them, not only the links they held.
        if preload is not None:
            if int_mode:
                pc = preload.columns
                ten.commit_int_cols(pc.link, pc.start)
            else:
                for t in preload.transfers:
                    ten.commit(t.link, t.start, t.end)
            ten.commit_stays(preload.columns)
        # <<< copy fix

        repl = replicate and int_mode and self._replication_safe(topo)
        ordered = self._order(self._dist_cache_for(topo), conds,
                              group_runs=repl)
        transfers: list[Transfer] = []
        search = bfs_int if int_mode else bfs_cont
        fast_commit = self._fast_int_commit(topo, int_mode)
        prev_key = None
        prev: PathResult | None = None
        prev_rel = 0.0
        for c in ordered:
            result: PathResult | None = None
            if repl:
                rd = c.remote_dests
                if len(rd) == 1:
                    result = self._fixed_route_schedule(ten, topo, c,
                                                        next(iter(rd)))
                else:
                    # release is deliberately NOT part of the run key:
                    # conditions identical up to their release floor (the
                    # pipelined regime's arrival-staggered bulk runs) still
                    # replicate. Identical-release replicas take the
                    # historical uniform shift; staggered replicas re-time
                    # the template tree hop by hop, because a uniform
                    # shift would stall the whole tree on any busy link
                    key = (c.src, c.dests, c.bytes)
                    if key == prev_key and prev is not None and prev.transfers:
                        if c.release == prev_rel:
                            result = self._shift_result(ten, prev, c)
                        else:
                            result = self._retime_tree(ten, prev, c)
                    if result is None:
                        result = search(ten, c)
                    prev_key, prev, prev_rel = key, result, c.release
            else:
                result = search(ten, c)
            if fast_commit:
                ten.commit_int_many(result.transfers)
            else:
                self._commit(ten, result, int_mode)
            transfers.extend(result.transfers)
        return CollectiveAlgorithm(topo, list(conds), transfers, name=name)

    def _route_for(self, topo: Topology, src: int, dest: int) -> tuple:
        """The canonical (src -> dest) hop sequence ((link, u, v), ...):
        what BFS finds on an uncongested TEN, memoized per topology."""
        ent = self._route_tens.get(id(topo))
        if ent is None or ent[0] is not topo:
            ent = (topo, TEN(topo), {})
            self._route_tens[id(topo)] = ent
        routes = ent[2]
        route = routes.get((src, dest))
        if route is None:
            found = bfs_int(ent[1], Condition(0, src, frozenset([dest])))
            route = tuple((t.link, t.src, t.dst) for t in found.transfers)
            routes[(src, dest)] = route
        return route

    def _fixed_route_schedule(self, ten: TEN, topo: Topology, c: Condition,
                              dest: int) -> PathResult:
        """Schedule one chunk along its memoized route with per-hop
        earliest-free waits (store-and-forward causality by construction)."""
        t = int(c.release)
        transfers = []
        arrivals = {c.src: float(t)}
        free = ten.earliest_free_int
        chunk = c.chunk
        for link, u, v in self._route_for(topo, c.src, dest):
            t = free(link, t)
            transfers.append(Transfer(chunk, link, u, v, float(t),
                                      float(t + 1)))
            t += 1
            arrivals[v] = float(t)
        return PathResult(transfers, arrivals, {dest: float(t)})

    @staticmethod
    def _replication_safe(topo: Topology) -> bool:
        """Path replication reasons about link occupancy only; switches with
        buffer limits or serialized egress add constraints a shifted path
        could violate, so those fabrics always take the full search."""
        return not topo.csr().constrained_switch

    @staticmethod
    def _shift_result(ten: TEN, base: PathResult,
                      c: Condition) -> PathResult | None:
        """Re-place ``base``'s path for a condition ``c`` identical up to
        its release by a uniform time shift onto free slots.

        The minimal feasible shift is a fixpoint of per-link next-free-slot
        queries (each O(1) on the occupancy masks), floored so the earliest
        shifted transfer starts no sooner than ``c.release``; a uniform
        shift preserves store-and-forward causality, so the result needs no
        re-validation. Returns None when no fixpoint is found within the
        iteration budget (the caller falls back to BFS)."""
        ts = base.transfers
        s_min = min(int(t.start) for t in ts)
        k = max(1, int(c.release) - s_min)
        for _ in range(64):
            k2 = k
            for t in ts:
                s = int(t.start) + k2
                free = ten.earliest_free_int(t.link, s)
                if free != s:
                    k2 += free - s
            if k2 == k:
                break
            k = k2
        else:
            return None
        kf = float(k)
        chunk = c.chunk
        transfers = [
            Transfer(chunk, t.link, t.src, t.dst, t.start + kf, t.end + kf,
                     t.reduce)
            for t in ts
        ]
        arrivals = {n: a + kf for n, a in base.arrivals.items()}
        reached = {n: a + kf for n, a in base.reached.items()}
        return PathResult(transfers, arrivals, reached)

    @staticmethod
    def _retime_tree(ten: TEN, base: PathResult,
                     c: Condition) -> PathResult:
        """Re-place ``base``'s multicast tree for a condition ``c`` that
        differs only in its release: each hop is re-timed independently to
        the earliest free slot at or after the chunk's arrival at that
        hop's source (store-and-forward causality by construction). Unlike
        a uniform shift, every hop absorbs its own queueing delay, so
        arrival-staggered bulk runs stay as tight on the template tree as
        a fresh search would be."""
        free = ten.earliest_free_int
        chunk = c.chunk
        arrivals: dict[int, float] = {c.src: float(int(c.release))}
        used: dict[int, int] = {}
        transfers = []
        for t in sorted(base.transfers, key=lambda t: t.start):
            s = int(arrivals[t.src])
            lk = t.link
            if lk in used and used[lk] >= s:
                s = used[lk] + 1
            s = free(lk, s)
            used[lk] = s
            transfers.append(Transfer(chunk, lk, t.src, t.dst,
                                      float(s), float(s + 1)))
            e = float(s + 1)
            if t.dst not in arrivals or e < arrivals[t.dst]:
                arrivals[t.dst] = e
        reached = {n: arrivals[n] for n in base.reached if n in arrivals}
        return PathResult(transfers, arrivals, reached)

    def synthesize_joint(
        self,
        groups: list[tuple[str, list[Condition]]],
        *,
        name: str = "pccl_joint",
    ) -> CollectiveAlgorithm:
        """Jointly synthesize several process groups' collectives over one
        shared TEN (paper §6.4, Fig. 15). Chunk ids across groups must be
        unique — use a shared ChunkIds allocator."""
        all_conds: list[Condition] = []
        for tag, conds in groups:
            all_conds.extend(replace(c, tag=tag) for c in conds)
        seen: set[int] = set()
        for c in all_conds:
            if c.chunk in seen:
                raise ValueError(
                    f"duplicate chunk id {c.chunk} across process groups"
                )
            seen.add(c.chunk)
        return self.synthesize(all_conds, name=name)

    # -- phase composition --------------------------------------------------

    def synthesize_plan(self, plan: PhasePlan) -> CollectiveAlgorithm:
        """Synthesize and stitch an ordered :class:`PhasePlan` into one
        algorithm on the engine's fabric.

        Phases share one absolute clock. For each phase, the release floor is
        ``max(start, end of every phase in after)``; phases carrying raw
        conditions are synthesized on their (sub-)topology with that floor
        folded into every condition's release, then lifted into global
        coordinates through ``node_map``/``link_map``/``chunk_map``. The
        result's conditions are ``plan.conditions`` — the caller's statement
        of what the composition achieves end to end — and ``phase_spans``
        records per-phase provenance. Congestion-freedom across phases comes
        from either disjoint link sets, disjoint time windows, or explicit
        ``preload_from``; the stitched algorithm still passes the full
        validation oracle, which checks all of it from scratch.
        """
        ends: dict[str, float] = {}
        local_algs: dict[str, CollectiveAlgorithm] = {}
        shifts: dict[str, float] = {}
        topos: dict[str, Topology] = {}
        lifted_cols: dict[str, TransferColumns] = {}
        merged: list[TransferColumns] = []
        spans: list[tuple[str, float, float]] = []
        for ph in plan.phases:
            if ph.name in ends:
                raise ValueError(f"duplicate phase name {ph.name!r}")
            if (ph.conds is None) == (ph.algorithm is None):
                raise ValueError(
                    f"phase {ph.name!r}: exactly one of conds/algorithm"
                )
            topo = ph.topology or self.topology
            floor = ph.start
            for dep in ph.after:
                if dep not in ends:
                    raise ValueError(
                        f"phase {ph.name!r} depends on unknown/later phase "
                        f"{dep!r}"
                    )
                floor = max(floor, ends[dep])
            chunk_floors = self._chunk_floors(ph, lifted_cols)
            shift = 0.0
            if ph.algorithm is not None:
                if chunk_floors is not None:
                    raise ValueError(
                        f"phase {ph.name!r}: per-chunk floors apply to "
                        f"conds phases only (a pre-timed algorithm cannot "
                        f"be shifted per chunk without re-synthesis)"
                    )
                # Pre-synthesized phases are canonically timed (their clock
                # starts at 0, which is what makes them cacheable across
                # isomorphic pods); the floor shifts them into place.
                alg = ph.algorithm
                shift = floor
            else:
                conds = ph.conds
                if floor > 0.0:
                    conds = [
                        c if c.release >= floor else replace(c, release=floor)
                        for c in conds
                    ]
                if chunk_floors is not None:
                    # raise-only, per chunk: the phase-local chunk id maps
                    # through chunk_map into the global id space the floor
                    # vector is keyed by
                    cm = ph.chunk_map or {}
                    out = []
                    for c in conds:
                        f = chunk_floors.get(cm.get(c.chunk, c.chunk), 0.0)
                        out.append(replace(c, release=f)
                                   if f > c.release else c)
                    conds = out
                preload = None
                if ph.preload_from:
                    pre: list[TransferColumns] = []
                    for dep in ph.preload_from:
                        if dep not in local_algs:
                            raise ValueError(
                                f"phase {ph.name!r} preloads unknown phase "
                                f"{dep!r}"
                            )
                        if topos[dep] is not topo:
                            raise ValueError(
                                f"phase {ph.name!r} preloads {dep!r} which "
                                f"ran on a different topology"
                            )
                        # occupy the dependency's *effective* window: its
                        # local transfers plus whatever floor shifted it
                        pre.append(
                            local_algs[dep].columns.shifted(shifts[dep]))
                    preload = CollectiveAlgorithm(
                        topo, [], TransferColumns.concat(pre),
                        name="preload")
                alg = self.synthesize(
                    conds, preload=preload, mode=ph.mode,
                    name=f"{plan.name}/{ph.name}", topology=topo,
                    replicate=ph.replicate,
                )
            local_algs[ph.name] = alg
            shifts[ph.name] = shift
            topos[ph.name] = topo
            lifted = self._lift(alg.columns, ph, topo, shift)
            lifted_cols[ph.name] = lifted
            merged.append(lifted)
            if len(lifted):
                t_lo = float(lifted.start.min())
                t_hi = float(lifted.end.max())
            else:
                t_lo = t_hi = floor
            ends[ph.name] = max(t_hi, floor)
            spans.append((ph.name, t_lo, t_hi))
            # multi-level composition: a phase that is itself a composed
            # algorithm (a recursive pod plan, a hierarchical RS inside an
            # All-Reduce) carries its own provenance — record it nested,
            # shifted onto this plan's clock, as "parent/child" entries
            for child, lo, hi in alg.phase_spans:
                spans.append((f"{ph.name}/{child}", lo + shift, hi + shift))
        result = CollectiveAlgorithm(
            self.topology, list(plan.conditions),
            TransferColumns.concat(merged), name=plan.name,
            phase_spans=spans,
        )
        if self._capture is not None:
            self._capture.append((plan, result))
        return result

    @staticmethod
    def _chunk_floors(
        ph: PhaseSpec, lifted_cols: dict[str, TransferColumns],
    ) -> dict[int, float] | None:
        """The phase's per-chunk floor vector (global chunk id -> absolute
        release floor), or None when the phase uses scalar floors only.

        ``floors_from`` dependencies contribute their per-chunk completion
        times — the max transfer end per global chunk over the dependency's
        *lifted* columns (so sub-topology phases and chunk renumbering are
        already folded in); explicit ``floors`` entries merge on top.
        Floors only ever raise releases downstream."""
        if not ph.floors_from and not ph.floors:
            return None
        done: dict[int, float] = {}
        for dep in ph.floors_from:
            cols = lifted_cols.get(dep)
            if cols is None:
                raise ValueError(
                    f"phase {ph.name!r} derives floors from unknown/later "
                    f"phase {dep!r}"
                )
            if not len(cols):
                continue
            uc, inv = np.unique(cols.chunk, return_inverse=True)
            dmax = np.full(len(uc), -np.inf)
            np.maximum.at(dmax, inv, cols.end)
            for ck, d in zip(uc.tolist(), dmax.tolist()):
                if d > done.get(ck, 0.0):
                    done[ck] = d
        for ck, f in (ph.floors or {}).items():
            if f > done.get(ck, 0.0):
                done[ck] = f
        return done

    def _lift(self, cols: TransferColumns, ph: PhaseSpec,
              topo: Topology, shift: float = 0.0) -> TransferColumns:
        """Translate one phase's transfer columns into global coordinates,
        shifted ``shift`` later (phases given as canonical pre-timed
        algorithms)."""
        cm = ph.chunk_map or {}
        if topo is self.topology:
            if ph.node_map is not None or ph.link_map is not None:
                raise ValueError(
                    f"phase {ph.name!r}: node/link maps only apply to "
                    f"sub-topology phases"
                )
            if not cm and shift == 0.0:
                return cols
            return cols.relabeled(chunk_map=cm, shift=shift)
        if ph.node_map is None or ph.link_map is None:
            raise ValueError(
                f"phase {ph.name!r}: sub-topology phases need node_map and "
                f"link_map to lift into {self.topology.name}"
            )
        return cols.relabeled(node_map=ph.node_map, link_map=ph.link_map,
                              chunk_map=cm, shift=shift)

    # -- registry routing ---------------------------------------------------

    def _routed(
        self,
        kind: str,
        group: Sequence[int],
        synth: Callable[[list[int]], CollectiveAlgorithm],
        *,
        params: tuple,
        ids: ChunkIds | None,
    ) -> CollectiveAlgorithm:
        """Fetch a named collective through the registry when one is attached;
        otherwise synthesize directly on the literal group."""
        group = list(group)
        if self.registry is None:
            return renumber_chunks(synth(group), ids)
        return self.registry.get_or_synthesize(
            self.topology, kind, group, synth, params=params, ids=ids
        )

    # -- hierarchical routing ----------------------------------------------

    def hierarchical(self):
        """The engine's :class:`repro.core.hierarchy.HierarchicalSynthesizer`
        (built lazily; shares this engine's TENs, distance caches, and
        registry)."""
        if self._hier is None:
            from repro_torch.core.hierarchy import HierarchicalSynthesizer

            self._hier = HierarchicalSynthesizer(self)
        return self._hier

    def _route_hierarchical(self, hierarchy: str, group) -> tuple[bool, tuple]:
        """Resolve a ``hierarchy`` policy ("auto"/"always"/"never") for one
        group: "auto" takes the hierarchical path exactly when the fabric is
        partitioned and the group spans pods. Returns ``(use_hier,
        route_params)`` — the latter goes into the registry key, and keeps
        "always" distinct from "auto": an auto call may legitimately fall
        back to a flat plan on a HierarchyError and cache it, but "always"
        must re-attempt the hierarchical route (and raise) instead of being
        served that cached flat fallback. On an unpartitioned fabric
        "always" is unsatisfiable and raises outright — a caller pinning
        the pod-aware path must not silently receive flat synthesis.

        Hierarchical routes additionally key on the *full partition-tree
        fingerprint*: the topology structure hash is partition-blind, so
        without it a plan cached for a 2-level view of a fabric would be
        served verbatim for a 3-level view of the same fabric (same
        structure, different ``set_partition``) — structurally valid but
        the wrong decomposition. Flat routes stay fingerprint-free: flat
        synthesis never consults the partition.

        Hierarchical routes also key on the *resolved* gateway strategy and
        the sketch fingerprint: a plan whose inter phase was routed
        round-robin must never be served to a TE or sketch-constrained
        request for the same group (and vice versa)."""
        if hierarchy == "always":
            if self.topology.partition is None:
                from repro_torch.core.hierarchy import HierarchyError

                raise HierarchyError(
                    f"hierarchy='always' on {self.topology.name}: the "
                    f"fabric has no partition (set_partition was never "
                    f"called), so the hierarchical path cannot be taken"
                )
            return True, (True, True, self.topology.partition_fingerprint(),
                          *self._te_route_params())
        if hierarchy == "never" or self.topology.partition is None:
            return False, (False, False, None)
        if hierarchy != "auto":
            raise ValueError(f"hierarchy={hierarchy!r} not in auto/always/never")
        use = self.hierarchical().spans_pods(group)
        if not use:
            return False, (False, False, None)
        return True, (True, False, self.topology.partition_fingerprint(),
                      *self._te_route_params())

    def _te_route_params(self) -> tuple:
        """(resolved gateway strategy, sketch fingerprint) for the registry
        route key. The strategy is resolved ("auto" -> "te" on
        heterogeneous boundary fabrics) so the label is stable per fabric
        and a later default change cannot silently re-serve stale plans."""
        h = self.hierarchical()
        sk = h.sketch
        return (h._effective_strategy(),
                sk.fingerprint() if sk is not None else None)

    # -- named collectives --------------------------------------------------

    def collective(
        self, request: CollectiveRequest, *, ids: ChunkIds | None = None,
    ) -> CollectiveAlgorithm:
        """Synthesize the collective described by ``request`` — the primary
        entry point; the named methods below are thin legacy shims over it.

        A request with ``gateway_strategy``/``sketch`` set synthesizes
        through a memoized engine variant configured accordingly (sharing
        this engine's topology and registry); ``None`` inherits this
        engine's configuration. ``ids`` stays a call-site argument: it is
        the caller's mutable chunk-id allocator, not part of the request's
        identity."""
        if request.gateway_strategy is None and request.sketch is None:
            return self._collective(request, ids=ids)
        return self._configured(
            request.gateway_strategy, request.sketch
        )._collective(request, ids=ids)

    def _configured(self, gateway_strategy, sketch) -> "SynthesisEngine":
        """A memoized engine variant with the given overrides (None =
        inherit), sharing topology + registry so cached plans cross over."""
        gs = (gateway_strategy if gateway_strategy is not None
              else self.gateway_strategy)
        sk = sketch if sketch is not None else self.sketch
        key = (gs, sk.fingerprint() if sk is not None else None)
        if gs == self.gateway_strategy and key[1] == (
                self.sketch.fingerprint() if self.sketch is not None
                else None):
            return self
        eng = self._variants.get(key)
        if eng is None:
            eng = SynthesisEngine(self.topology, registry=self.registry,
                                  gateway_strategy=gs, sketch=sk)
            eng.degradation = self.degradation
            self._variants[key] = eng
        return eng

    def _collective(
        self, req: CollectiveRequest, *, ids: ChunkIds | None,
    ) -> CollectiveAlgorithm:
        group = list(req.group)
        if not group:
            raise ValueError(f"{req.kind}: request has an empty group")
        kind = req.kind
        if kind == "reduce":
            root_pos = group.index(req.root)

            def synth(g: list[int]) -> CollectiveAlgorithm:
                return self._reduce_impl(g, g[root_pos], bytes=req.bytes)

            return self._routed("reduce", group, synth,
                                params=self._params(req, None), ids=ids)
        use_hier, route = self._route_hierarchical(req.hierarchy, group)

        def synth(g: list[int]) -> CollectiveAlgorithm:
            if use_hier:
                from repro_torch.core.hierarchy import HierarchyError

                try:
                    # >>> copy fix: a hierarchical plan that overfills a switch
                    # A gateway switch holds a chunk from one phase to the
                    # next. Where that overfills its buffer, the auto route
                    # synthesizes the collective flat, as on a HierarchyError.
                    alg = self._hier_impl(kind, g, req)
                    if (req.hierarchy == "always" or self.sketch is not None
                            or not _overfills(alg)):
                        return alg
                    # <<< copy fix
                except HierarchyError:
                    # HierarchyError is advisory (see repro.core.errors):
                    # the auto route may retry flat — unless the caller
                    # pinned the hierarchical path or a sketch is attached
                    # (a flat plan would ignore its hard constraints)
                    if req.hierarchy == "always" or self.sketch is not None:
                        raise
            return self._flat_impl(kind, g, req)

        return self._routed(kind, group, synth,
                            params=self._params(req, route), ids=ids)

    def _params(self, req: CollectiveRequest, route) -> tuple:
        """The request's registry params, extended with the degradation
        fingerprint on degraded-fabric engines (see ``self.degradation``)."""
        params = req.registry_params(route)
        if self.degradation is not None:
            params = (*params, ("degraded", self.degradation))
        return params

    def _hier_impl(self, kind, g, req: CollectiveRequest):
        h = self.hierarchical()
        if kind == "all_gather":
            return h.all_gather(g, bytes=req.bytes, chunks_per_npu=req.chunks)
        if kind == "all_to_all":
            return h.all_to_all(g, bytes=req.bytes, chunks_per_pair=req.chunks)
        if kind == "reduce_scatter":
            return h.reduce_scatter(g, bytes=req.bytes,
                                    chunks_per_npu=req.chunks)
        return h.all_reduce(g, bytes=req.bytes)

    # >>> copy fix: flat reductions in waves where a switch buffer overfills
    def _flat_impl(self, kind, g, req: CollectiveRequest):
        alg = self._flat_plan(kind, g, req)
        if kind in ("reduce_scatter", "all_reduce") and _overfills(alg):
            return self._in_waves(kind, g, req)
        return alg

    def _in_waves(self, kind, g, req: CollectiveRequest):
        """A Reduce-Scatter or All-Reduce in waves of at most as many chunks
        as the smallest limited buffer takes, each wave after the one
        before: no more chunks than that are ever in flight, so no buffer
        overfills. An All-Reduce holds each chunk in a switch from its
        reduction to its gather, one stay of two phases; a reduction's
        stays are timed on the reversed fabric, exactly only on unit
        links. A flat All-Gather or All-To-All is one search a chunk, whose
        stays the searches keep whole."""
        topo = self.topology
        wave = max(1, min(topo.nodes[s].buffer_limit
                          for s in topo.csr().limited_switches))
        rconds = cnd.reduce_scatter(g, ids=ChunkIds(0), bytes=req.bytes,
                                    chunks_per_npu=(req.chunks if kind ==
                                                    "reduce_scatter" else 1))
        phases, prev = [], ()
        for k in range(0, len(rconds), wave):
            part = rconds[k:k + wave]
            ag = cnd.gather_view(part, tag="rev_ag")
            alg = self._reverse_algorithm(
                self.synthesize(ag, name="pccl_reduce_scatter",
                                topology=self.reversed_topology()), part)
            rs = f"reduce_scatter{k // wave}"
            phases.append(PhaseSpec(rs, algorithm=alg, after=prev))
            prev = (rs,)
            if kind == "all_reduce":
                ag_conds = [Condition(c.chunk, next(iter(c.dests)),
                                      frozenset(g), bytes=req.bytes,
                                      tag="allreduce_ag") for c in part]
                name = f"all_gather{k // wave}"
                phases.append(PhaseSpec(
                    name, conds=ag_conds, preload_from=(rs,),
                    floors_from=(rs,) if req.pipelined else (),
                    after=() if req.pipelined else (rs,)))
                prev = (rs, name)
        if kind == "all_reduce":
            rconds = [ReduceCondition(c.chunk, frozenset(g), frozenset(g),
                                      bytes=req.bytes) for c in rconds]
        return self.synthesize_plan(
            PhasePlan(phases, rconds, name=f"pccl_{kind}"))

    def _flat_plan(self, kind, g, req: CollectiveRequest):
    # <<< copy fix
        if kind == "all_gather":
            conds = cnd.all_gather(g, ids=ChunkIds(), bytes=req.bytes,
                                   chunks_per_npu=req.chunks)
            return self.synthesize(conds, name="pccl_all_gather")
        if kind == "all_to_all":
            conds = cnd.all_to_all(g, ids=ChunkIds(), bytes=req.bytes,
                                   chunks_per_pair=req.chunks)
            return self.synthesize(conds, name="pccl_all_to_all")
        if kind == "reduce_scatter":
            return self._reduce_scatter_impl(g, bytes=req.bytes,
                                             chunks_per_npu=req.chunks)
        return self._all_reduce_impl(g, bytes=req.bytes,
                                     pipelined=req.pipelined)

    # -- legacy kwarg shims -------------------------------------------------

    def _shim(self, kind, group, explicit, ids, **req_kw):
        """Common body of the legacy named-collective shims: accept a
        CollectiveRequest positionally, else build one from the legacy
        kwargs — warning (with the *caller's* frame blamed) only when a
        tuning kwarg was explicitly passed, so bare ``eng.all_gather(g)``
        stays silent sugar."""
        if isinstance(group, CollectiveRequest):
            if group.kind != kind:
                raise ValueError(
                    f"SynthesisEngine.{kind}() got a {group.kind!r} request")
            if explicit:
                raise TypeError(
                    f"SynthesisEngine.{kind}(): pass tuning in the "
                    f"CollectiveRequest, not alongside it")
            return self.collective(group, ids=ids)
        if explicit:
            warnings.warn(
                f"SynthesisEngine.{kind}({', '.join(sorted(explicit))}) "
                f"kwargs are deprecated; pass a CollectiveRequest to "
                f"SynthesisEngine.collective()",
                PCCLDeprecationWarning, stacklevel=3)
        req = CollectiveRequest(kind, group=tuple(group), **req_kw)
        return self._collective(req, ids=ids)

    def all_gather(
        self, group, *, bytes=_UNSET, chunks_per_npu=_UNSET, ids=None,
        hierarchy=_UNSET,
    ) -> CollectiveAlgorithm:
        explicit = {k for k, v in (("bytes", bytes),
                                   ("chunks_per_npu", chunks_per_npu),
                                   ("hierarchy", hierarchy))
                    if v is not _UNSET}
        return self._shim(
            "all_gather", group, explicit, ids,
            bytes=1.0 if bytes is _UNSET else bytes,
            chunks=1 if chunks_per_npu is _UNSET else chunks_per_npu,
            hierarchy="auto" if hierarchy is _UNSET else hierarchy)

    def all_to_all(
        self, group, *, bytes=_UNSET, chunks_per_pair=_UNSET, ids=None,
        hierarchy=_UNSET,
    ) -> CollectiveAlgorithm:
        explicit = {k for k, v in (("bytes", bytes),
                                   ("chunks_per_pair", chunks_per_pair),
                                   ("hierarchy", hierarchy))
                    if v is not _UNSET}
        return self._shim(
            "all_to_all", group, explicit, ids,
            bytes=1.0 if bytes is _UNSET else bytes,
            chunks=1 if chunks_per_pair is _UNSET else chunks_per_pair,
            hierarchy="auto" if hierarchy is _UNSET else hierarchy)

    def reduce(
        self, group, root=None, *, bytes=_UNSET, ids=None,
    ) -> CollectiveAlgorithm:
        if isinstance(group, CollectiveRequest):
            if root is not None:
                raise TypeError(
                    "SynthesisEngine.reduce(): root lives in the request")
            return self._shim("reduce", group, set(), ids)
        if root is None:
            raise TypeError("SynthesisEngine.reduce() needs root")
        explicit = {"bytes"} if bytes is not _UNSET else set()
        return self._shim(
            "reduce", group, explicit, ids,
            bytes=1.0 if bytes is _UNSET else bytes, root=root)

    def reduce_scatter(
        self, group, *, bytes=_UNSET, chunks_per_npu=_UNSET, ids=None,
        hierarchy=_UNSET,
    ) -> CollectiveAlgorithm:
        explicit = {k for k, v in (("bytes", bytes),
                                   ("chunks_per_npu", chunks_per_npu),
                                   ("hierarchy", hierarchy))
                    if v is not _UNSET}
        return self._shim(
            "reduce_scatter", group, explicit, ids,
            bytes=1.0 if bytes is _UNSET else bytes,
            chunks=1 if chunks_per_npu is _UNSET else chunks_per_npu,
            hierarchy="auto" if hierarchy is _UNSET else hierarchy)

    def all_reduce(
        self, group, *, bytes=_UNSET, ids=None, pipelined=_UNSET,
        hierarchy=_UNSET,
    ) -> CollectiveAlgorithm:
        """All-Reduce = Reduce-Scatter then All-Gather. Pod-spanning groups
        on partitioned fabrics route hierarchically (both halves composed
        through the pod-aware pipeline); ``pipelined`` applies to the flat
        route only — the hierarchical composition runs its phases on the
        dependency floors derived by ``synthesize_plan``."""
        explicit = {k for k, v in (("bytes", bytes),
                                   ("pipelined", pipelined),
                                   ("hierarchy", hierarchy))
                    if v is not _UNSET}
        return self._shim(
            "all_reduce", group, explicit, ids,
            bytes=1.0 if bytes is _UNSET else bytes,
            pipelined=False if pipelined is _UNSET else pipelined,
            hierarchy="auto" if hierarchy is _UNSET else hierarchy)

    # -- reduction internals (paper §4.5, Fig. 8) ---------------------------

    def _reverse_algorithm(
        self,
        alg: CollectiveAlgorithm,
        reduce_conds: list[ReduceCondition],
    ) -> CollectiveAlgorithm:
        """See :func:`time_reversed` — engine-local wrapper binding the
        forward fabric."""
        return time_reversed(self.topology, alg, reduce_conds)

    def _reduce_impl(
        self, group: list[int], root: int, *, bytes: float = 1.0,
    ) -> CollectiveAlgorithm:
        rconds = cnd.reduce(group, root, ids=ChunkIds(0), bytes=bytes)
        bcast = cnd.gather_view(rconds, tag="rev_bcast")
        alg = self.synthesize(bcast, name="pccl_reduce",
                              topology=self.reversed_topology())
        return self._reverse_algorithm(alg, rconds)

    def _reduce_scatter_impl(
        self, group: list[int], *, bytes: float = 1.0, chunks_per_npu: int = 1,
    ) -> CollectiveAlgorithm:
        rconds = cnd.reduce_scatter(group, ids=ChunkIds(0), bytes=bytes,
                                    chunks_per_npu=chunks_per_npu)
        ag = cnd.gather_view(rconds, tag="rev_ag")
        alg = self.synthesize(ag, name="pccl_reduce_scatter",
                              topology=self.reversed_topology())
        return self._reverse_algorithm(alg, rconds)

    def _all_reduce_impl(
        self, group: list[int], *, bytes: float = 1.0, pipelined: bool = False,
    ) -> CollectiveAlgorithm:
        """All-Reduce = Reduce-Scatter then All-Gather (paper §4.5), composed
        as a two-phase :class:`PhasePlan`. Each NPU in the group owns one
        shard-chunk. With ``pipelined=True`` (beyond-paper), each chunk's
        All-Gather is released at that chunk's Reduce-Scatter completion
        instead of the global makespan; ``preload_from`` keeps the
        overlapping phases congestion-free on the shared links."""
        rs = self._reduce_scatter_impl(group, bytes=bytes)
        owner = {c.chunk: next(iter(c.dests)) for c in rs.conditions}
        ag_conds = [
            Condition(c.chunk, owner[c.chunk], frozenset(group), bytes=bytes,
                      tag="allreduce_ag")
            for c in rs.conditions
        ]
        ar_conds = [
            ReduceCondition(c.chunk, frozenset(group), frozenset(group),
                            bytes=bytes)
            for c in rs.conditions
        ]
        # pipelined: each chunk's gather releases at its own reduce
        # completion — the per-chunk floor vector derived from the RS
        # phase's columns; barrier mode floors the whole phase at RS end
        plan = PhasePlan(
            phases=[
                PhaseSpec("reduce_scatter", algorithm=rs),
                PhaseSpec("all_gather", conds=ag_conds,
                          preload_from=("reduce_scatter",),
                          floors_from=(("reduce_scatter",) if pipelined
                                       else ()),
                          after=(() if pipelined else ("reduce_scatter",))),
            ],
            conditions=ar_conds,
            name="pccl_all_reduce",
        )
        return self.synthesize_plan(plan)
