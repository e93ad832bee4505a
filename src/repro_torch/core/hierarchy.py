"""Hierarchical synthesis pipeline for partitioned (multi-pod) fabrics.

Flat PCCL synthesis re-pays the full time-expanded-network cost for every
isomorphic pod of a multi-pod fabric, which is what keeps 1k+ NPU fabrics
out of reach. This module exploits the partition metadata on
:class:`repro.topology.topology.Topology` (TACCL-style: sketch the
intra-/inter-pod split, synthesize each piece) to decompose a collective
into phases:

* **intra phases** — one per pod, synthesized on the pod's small
  sub-topology. Conditions are expressed in pod-local coordinates with
  pod-locally assigned gateways, so every structurally-identical pod
  produces the same sub-problem: the :class:`AlgorithmRegistry` (keyed by
  the sub-topology fingerprint + a condition-signature hash) pays one
  synthesis for N isomorphic pods.
* **an inter phase** — synthesized on the boundary sub-topology (boundary
  links, shared switches, gateway NPUs), moving each chunk between its
  egress and ingress gateways.
* **scatter phases** — one per pod, delivering arrived remote chunks to the
  pod's group members; registry-shared like the intra phases.

The phases are stitched by :meth:`SynthesisEngine.synthesize_plan` into one
:class:`CollectiveAlgorithm` on the full fabric that the validation oracle,
``replay_algorithm``, and the differential suites accept unchanged.

The decomposition is *recursive* (pods-of-pods): partitions form a tree
(:meth:`Topology.set_partition` with nested paths), ``pod_subtopology``
returns a fabric carrying the next level's partition, and an intra/scatter
phase whose conditions span the sub-fabric's own pods re-enters the
pipeline through the generic :meth:`HierarchicalSynthesizer.spanning`
decomposition — so a rack -> pod -> plane fabric synthesizes through three
phase levels, with canonical per-rack plans registry-shared across every
isomorphic rack of every pod. Nested phase provenance is recorded as
``"parent/child"`` spans and survives time reversal, so the reduction
collectives work at depth >= 3 unchanged.

Reductions take the same pipeline through time reversal (paper §4.5, the
TACOS reverse-topology trick applied per phase): a hierarchical
Reduce-Scatter is the reversal of a hierarchical All-Gather synthesized on
the link-reversed fabric (which carries the same partition metadata), and a
hierarchical All-Reduce composes that with the forward hierarchical
All-Gather through :class:`PhasePlan`. Per-pod broadcast plans on the
reversed pod sub-topologies are registry-shared exactly like the forward
ones, so N isomorphic pods still pay one synthesis per phase kind.

Two pipelining regimes:

* **pipelined** (small fabrics, boundary links disjoint from pod links):
  inter conditions release per-chunk at the chunk's gateway arrival, and
  scatter phases overlap their pod's intra phase safely by preloading its
  transfers into the shared sub-TEN — makespans land close to flat
  synthesis.
* **sequential** (default at scale, or when the boundary fabric shares
  links with pod fabrics): phases execute back-to-back, every per-pod plan
  is canonically timed from 0 and therefore registry-shareable across pods
  and across runs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core import conditions as cnd
from repro_torch.core.algorithm import CollectiveAlgorithm, TransferColumns, \
    remap_ids
from repro_torch.core.conditions import ChunkIds, Condition, ReduceCondition
from repro_torch.core.engine import PhasePlan, PhaseSpec, SynthesisEngine, \
    time_reversed
from repro_torch.core.errors import PCCLError
from repro_torch.core.registry import renumber_chunks
from repro_torch.core.traffic import CommSketch, SketchInfeasibleError, \
    TrafficEngineer
from repro_torch.topology.topology import Topology, TopologyView

# pipeline="auto" pipelines fabrics up to this many group members; larger
# groups prefer the sequential regime, whose per-pod plans are
# registry-shareable (one synthesis for N pods) at the cost of phase
# barriers.
_AUTO_PIPELINE_MAX_GROUP = 256


class HierarchyError(PCCLError, ValueError):
    """The group/fabric cannot take the hierarchical path (no partition,
    single pod, missing gateways, unreachable pods). Callers fall back to
    flat synthesis — the advisory end of the :class:`PCCLError` fallback
    contract (see :mod:`repro.core.errors`). ``ValueError`` ancestry is
    kept for backward compatibility."""


def _uniform_singletons(conds: list[Condition]) -> bool:
    """True when every condition is single-destination with equal
    (bytes, release, tag) — bulk All-to-All phase shape, eligible for the
    vectorized canonicalize/signature paths."""
    c0 = conds[0]
    b0, r0, t0 = c0.bytes, c0.release, c0.tag
    return all(
        len(c.dests) == 1 and c.bytes == b0 and c.release == r0
        and c.tag == t0
        for c in conds
    )


def _signature(conds: list[Condition]) -> str:
    """Stable hash of a phase-local condition multiset — the registry cache
    key component that distinguishes condition patterns on equal-fingerprint
    sub-topologies. Bulk uniform-singleton phases hash a packed numpy view
    of the same information (domain-tagged so the two encodings can never
    collide)."""
    h = hashlib.sha256()
    if len(conds) > 4096 and _uniform_singletons(conds):
        c0 = conds[0]
        h.update(repr(("bulk1", c0.bytes, c0.release, c0.tag)).encode())
        arr = np.fromiter(
            (v for c in conds for v in (c.chunk, c.src, next(iter(c.dests)))),
            dtype=np.int64, count=3 * len(conds),
        )
        h.update(arr.tobytes())
        return h.hexdigest()
    for c in conds:
        h.update(repr((c.chunk, c.src, tuple(sorted(c.dests)), c.bytes,
                       c.release, c.tag)).encode())
    return h.hexdigest()


def _arrivals(transfers) -> dict[tuple[int, int], float]:
    """(chunk, node) -> earliest arrival end time."""
    cols = getattr(transfers, "columns", None)
    if cols is None:  # plain iterable of Transfer objects
        arr: dict[tuple[int, int], float] = {}
        for t in transfers:
            key = (t.chunk, t.dst)
            got = arr.get(key)
            if got is None or t.end < got:
                arr[key] = t.end
        return arr
    if not len(cols):
        return {}
    uk, amin = _min_by_key(cols.chunk, cols.dst, cols.end)
    return {(int(k >> 32), int(k & 0xFFFFFFFF)): e
            for k, e in zip(uk.tolist(), amin.tolist())}


def _min_by_key(chunk: np.ndarray, node: np.ndarray,
                end: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Earliest ``end`` per packed (chunk, node) key — the vectorized heart
    of the per-chunk arrival floors (node ids fit 32 bits by construction)."""
    key = chunk.astype(np.int64) * (1 << 32) + node.astype(np.int64)
    uk, inv = np.unique(key, return_inverse=True)
    amin = np.full(len(uk), np.inf)
    np.minimum.at(amin, inv, end)
    return uk, amin


def _canonicalize_phase(conds: list[Condition]) -> tuple[list[Condition],
                                                         dict[int, int]]:
    """Sort a phase's conditions into a pod-invariant order and renumber
    chunks densely from 0.

    Phase builders iterate the overall condition list, whose order is
    pod-dependent (pod 0's sources meet their same-pod destinations first,
    later pods meet cross-pod destinations first), so positional chunk ids
    would make byte-identical pod sub-problems hash differently and defeat
    registry sharing. Sorting by the condition content itself — (src, dests,
    bytes, release, tag), ties keeping build order — makes isomorphic pods
    produce literally equal condition lists. Returns the canonical local
    conditions and the local -> global chunk map."""
    n = len(conds)
    if n > 4096 and _uniform_singletons(conds):
        src = np.fromiter((c.src for c in conds), dtype=np.int64, count=n)
        dst = np.fromiter((next(iter(c.dests)) for c in conds),
                          dtype=np.int64, count=n)
        order = np.lexsort((np.arange(n), dst, src))
    else:
        order = sorted(
            range(n),
            key=lambda k: (conds[k].src, tuple(sorted(conds[k].dests)),
                           conds[k].bytes, conds[k].release, conds[k].tag, k),
        )
    local = [
        Condition(i, conds[k].src, conds[k].dests, conds[k].bytes,
                  conds[k].release, conds[k].tag)
        for i, k in enumerate(order)
    ]
    cmap = {i: conds[k].chunk for i, k in enumerate(order)}
    return local, cmap


@dataclass
class _PodCtx:
    """Per-pod derived state: the sub-topology view and gateway geometry."""

    pod: int
    view: TopologyView
    gateways: list[int]  # global ids
    gateways_local: list[int]  # local ids, same order


class HierarchicalSynthesizer:
    """Drives the partition-aware synthesis pipeline over one fabric.

    Holds one :class:`SynthesisEngine` (whose per-topology TEN/distance
    caches serve every pod's sub-problem) and, when the engine carries a
    registry, shares canonical per-pod sub-plans through it.
    """

    def __init__(self, engine: SynthesisEngine):
        self.engine = engine
        self.topology = engine.topology
        self.registry = engine.registry
        self._rev_hier: "HierarchicalSynthesizer | None" = None
        # nested synthesizers for partitioned pod sub-topologies (the
        # pods-of-pods recursion), keyed by object id with identity guard
        self._nested: dict[int, tuple[Topology,
                                      "HierarchicalSynthesizer"]] = {}
        self._pods: dict[int, _PodCtx] = {}
        self._bview: TopologyView | None = None
        self._bdist: dict[int, list[int]] = {}  # bsub-local src -> dist row
        self._pod_dist_to_gw: dict[tuple[int, int], list[int]] = {}
        self._pod_dist_from_gw: dict[tuple[int, int], list[int]] = {}
        self._reach_cache: dict[tuple[int, int], list] = {}
        self._ingress_cache: dict[tuple[int, int], int] = {}
        self._nearest_cache: dict[tuple[int, int], int] = {}
        # dest-set -> {pod: members} buckets, memoized by frozenset identity
        # (bulk collectives share ONE dests object across all conditions)
        self._dest_buckets: dict[int, tuple] = {}
        # Gateway selection strategy for the inter-pod phase:
        #   "te"          — min-max link-load traffic engineering over the
        #                   boundary fabric (see repro.core.traffic)
        #   "round_robin" — legacy ordinal cycling (optimal only on
        #                   homogeneous boundaries, where equal counts mean
        #                   equal time)
        #   "aligned"     — All-to-All only: pod-pair-aligned gateway
        #                   cycling (few distinct inter endpoints, longest
        #                   replication runs)
        #   "nearest"     — All-to-All only: gateways closest to each
        #                   source/destination (shortest intra legs)
        #   "auto"        — "te" when some pod's gateway uplinks are
        #                   mutually heterogeneous or a sketch is present
        #                   (round-robin counts balance load exactly when
        #                   the uplinks they cycle over are uniform, so TE
        #                   engages exactly where count-balancing breaks),
        #                   else the legacy per-collective default.
        # A CommSketch always routes through the TE assigner: its
        # constraints are hard, and only the engineer enforces them.
        self.gateway_strategy = getattr(engine, "gateway_strategy", "auto")
        self.sketch: CommSketch | None = getattr(engine, "sketch", None)
        # canonical boundary routes, shared across TrafficEngineer
        # instances (routes depend on the fabric, not on load state)
        self._te_routes: dict = {}
        self._gateway_cands: dict[int, list[int]] = {}
        self._auto_te: bool | None = None  # memoized "auto" resolution
        self._attach: dict[int, tuple[float, float]] | None = None

    # -- eligibility --------------------------------------------------------

    def spans_pods(self, group) -> bool:
        """True iff the fabric is partitioned and ``group`` crosses a pod
        boundary with every member assigned to a pod."""
        part = self.topology.partition
        if part is None:
            return False
        pods = {part[m] for m in group}
        return -1 not in pods and len(pods) > 1

    def spans_conditions(self, conds) -> bool:
        """Condition-level :meth:`spans_pods`: True iff every endpoint of
        every condition is pod-assigned and the set crosses a pod boundary —
        the eligibility test for :meth:`spanning` (and for the recursion
        into a partitioned pod sub-topology)."""
        part = self.topology.partition
        if part is None or not conds:
            return False
        pods: set[int] = set()
        for c in conds:
            pods.add(part[c.src])
            pods.update(self._dest_pod_buckets(c))
        return -1 not in pods and len(pods) > 1

    def _require(self, group) -> list[int]:
        if not self.spans_pods(group):
            raise HierarchyError(
                f"group does not span pods of {self.topology.name}"
            )
        part = self.topology.partition
        involved = sorted({part[m] for m in group})
        for p in involved:
            if not self.topology.gateways(p):
                raise HierarchyError(f"pod {p} has no gateway NPUs")
        return involved

    # -- derived geometry ---------------------------------------------------

    def _pod(self, p: int) -> _PodCtx:
        ctx = self._pods.get(p)
        if ctx is None:
            view = self.topology.pod_subtopology(p)
            gws = self.topology.gateways(p)
            ctx = _PodCtx(p, view, gws, [view.to_local[g] for g in gws])
            self._pods[p] = ctx
        return ctx

    def _boundary(self) -> TopologyView:
        """The boundary fabric the inter phase runs on — with the sketch's
        node/link exclusions carved out, so reachability, TE assignment and
        inter-phase synthesis physically cannot touch excluded hardware."""
        if self._bview is None:
            bview = self.topology.boundary_subtopology()
            sk = self.sketch
            if sk is not None and sk.excludes_hardware:
                drop = sk.exclude_nodes
                keep_nodes = [n for n in bview.nodes if n not in drop]
                keep_links = [
                    l for l in bview.links
                    if l not in sk.exclude_links
                    and self.topology.links[l].src not in drop
                    and self.topology.links[l].dst not in drop
                ]
                bview = self.topology._extract(
                    keep_nodes, keep_links,
                    f"{self.topology.name}:boundary:sketch",
                )
            self._bview = bview
        return self._bview

    def _effective_strategy(self) -> str:
        """Resolve ``gateway_strategy`` for this fabric. A sketch always
        engages the traffic engineer (only it enforces the constraints);
        "auto" engages it exactly where round-robin's count balancing stops
        being load balancing — some pod's gateway uplinks mutually
        heterogeneous, so equal chunk counts mean unequal busy time — and
        keeps the legacy per-collective default elsewhere (including
        fabrics whose tiers differ but whose uplinks are uniform within
        each pod, where count cycling is already load-balanced and the
        engineer's attachment model adds nothing). Deterministic per
        (fabric, strategy, sketch), so the resolved value is also the
        registry route label."""
        if self.sketch is not None:
            return "te"
        s = self.gateway_strategy
        if s != "auto":
            return s
        if self._auto_te is None:
            self._auto_te = self._skewed_uplinks()
        return "te" if self._auto_te else "auto"

    def _skewed_uplinks(self) -> bool:
        """True iff some pod's gateways attach to the boundary fabric over
        mutually heterogeneous links — the regime where round-robin's
        per-count cycling provably misbalances busy time."""
        bsub = self._boundary().topology
        bl = self._boundary().to_local
        for p in range(self.topology.num_pods):
            timings = set()
            for g in self.topology.gateways(p):
                gl = bl.get(g)
                if gl is None:
                    continue
                for l in bsub.out_links(gl):
                    timings.add((l.alpha, l.beta))
                    if len(timings) > 1:
                        return True
        return False

    def _gateway_candidates(self, p: int) -> list[int]:
        """Pod-``p`` gateways usable by the traffic engineer: present on
        the (possibly sketch-filtered) boundary fabric and allowed by the
        sketch's affinity. Affinity ids are validated once per pod."""
        got = self._gateway_cands.get(p)
        if got is not None:
            return got
        ctx = self._pod(p)
        bl = self._boundary().to_local
        gws = [g for g in ctx.gateways if g in bl]
        sk = self.sketch
        if sk is not None:
            allowed = sk.allowed_gateways(p)
            if allowed is not None:
                bad = sorted(set(allowed) - set(ctx.gateways))
                if bad:
                    raise SketchInfeasibleError(
                        f"sketch gateway_affinity for pod {p} names "
                        f"non-gateway nodes {bad}")
                aset = set(allowed)
                gws = [g for g in gws if g in aset]
        if not gws:
            if sk is not None:
                raise SketchInfeasibleError(
                    f"pod {p}: sketch leaves no usable boundary gateway")
            raise HierarchyError(
                f"pod {p} has no gateway on the boundary fabric")
        self._gateway_cands[p] = gws
        return gws

    def _attach_costs(self) -> dict[int, tuple[float, float, int]]:
        """Per-gateway (alpha, beta, out-degree) of the fastest pod-internal
        link adjacent to the gateway — the raw material for the engineer's
        virtual attachment links, modeling the intra/scatter serialization
        that funneling chunks through one gateway costs inside its pod.
        Without this the assigner would route every chunk through the
        fastest uplink's gateway and the pod phases would serialize behind
        that single node."""
        if self._attach is None:
            attach: dict[int, tuple[float, float, int]] = {}
            for p in range(self.topology.num_pods):
                ctx = self._pod(p)
                sub = ctx.view.topology
                for g, gl in zip(ctx.gateways, ctx.gateways_local):
                    links = sub.out_links(gl)
                    if not links:
                        continue
                    l0 = min(links, key=lambda l: (l.transfer_time(1.0),
                                                   l.id))
                    attach[g] = (l0.alpha, l0.beta, len(links))
            self._attach = attach
        return self._attach

    def _traffic_engineer(self, *, multicast: bool) -> TrafficEngineer:
        """A fresh engineer over the boundary fabric. ``multicast`` picks
        the ingress-side attachment model: a multicast scatter forwards
        each chunk over every source link of its fan-out tree (full link
        time per chunk), a unicast delivery spreads chunks across the
        gateway's pod links (per-chunk cost divided by out-degree). The
        egress side is always fan-in: deg-divided."""
        bview = self._boundary()
        raw = self._attach_costs()
        eg = {g: (a / d, b / d) for g, (a, b, d) in raw.items()}
        if multicast:
            ing = {g: (a, b) for g, (a, b, _) in raw.items()}
        else:
            ing = eg
        return TrafficEngineer(bview.topology, bview.to_local,
                               sketch=self.sketch,
                               route_cache=self._te_routes,
                               attach_egress=eg, attach_ingress=ing)

    def _assign_te(self, demands, egress, ingress) -> None:
        """Run the traffic engineer over the collected spanning demand
        matrix and write the chosen gateways back into the routing maps
        (``egress[chunk]``, ``ingress[(chunk, dest pod)]``). Without a
        sketch, the legacy round-robin choice is scored under the same load
        model and adopted if strictly better (never-worse guarantee); with
        a sketch, round-robin may violate hard constraints and is never
        consulted."""
        te = self._traffic_engineer(multicast=True)
        rr = None
        if self.sketch is None:
            rr = []
            for c, p, qs, k in demands:
                gws = self._pod(p).gateways
                e = gws[k % len(gws)]
                picks = {}
                for q in qs:
                    cand = self._reachable_gateways(e, q)
                    picks[q] = cand[k % len(cand)][2]
                rr.append((e, picks))
        for c, p, qs, k in demands:
            cands = {q: self._gateway_candidates(q) for q in qs}
            try:
                te.assign(c.chunk, p, self._gateway_candidates(p), cands,
                          c.bytes)
            except SketchInfeasibleError:
                raise
            except ValueError as err:
                raise HierarchyError(str(err)) from err
        te.refine()
        if rr is not None:
            te.better_of(rr)
        for key, e, picks in te.assignments():
            egress[key] = e
            for q, i in picks.items():
                ingress[(key, q)] = i

    def _assign_te_a2a(self, demands, egress, ingress) -> None:
        """All-to-All variant of :meth:`_assign_te`: one destination pod
        per demand, with an ingress tie-break preferring the gateway
        nearest the final destination inside its pod (the legacy
        nearest-ingress objective, now subordinate to link load)."""
        te = self._traffic_engineer(multicast=False)
        rr = None
        if self.sketch is None:
            rr = []
            for c, p, q, d, k in demands:
                gws = self._pod(p).gateways
                e = gws[k % len(gws)]
                cand = self._reachable_gateways(e, q)
                rr.append((e, {q: cand[k % len(cand)][2]}))
        gw_local: dict[int, dict[int, int]] = {}
        for c, p, q, d, k in demands:
            gl = gw_local.get(q)
            if gl is None:
                ctxq = self._pod(q)
                gl = gw_local[q] = dict(zip(ctxq.gateways,
                                            ctxq.gateways_local))
            dl = self._pod(q).view.to_local[d]

            def tie(_q, g, __q=q, __dl=dl, __gl=gl):
                return self._dist_from_gateway(__q, __gl[g])[__dl]

            try:
                te.assign(c.chunk, p, self._gateway_candidates(p),
                          {q: self._gateway_candidates(q)}, c.bytes,
                          ingress_tie=tie)
            except SketchInfeasibleError:
                raise
            except ValueError as err:
                raise HierarchyError(str(err)) from err
        te.refine()
        if rr is not None:
            te.better_of(rr)
        for key, e, picks in te.assignments():
            egress[key] = e
            ingress[key] = next(iter(picks.values()))

    def _bdist_row(self, src_local: int) -> list[int]:
        """Hop distances from one bsub-local node over the boundary fabric."""
        row = self._bdist.get(src_local)
        if row is None:
            sub = self._boundary().topology
            matrix = sub.hop_matrix()
            if matrix is not None:
                row = [-1 if x == float("inf") else int(x)
                       for x in matrix[src_local]]
            else:
                row = sub.hop_distances_from(src_local)
            self._bdist[src_local] = row
        return row

    def _dist_to_gateway(self, p: int, gw_local: int) -> list[int]:
        """Pod-local hop distance from every pod node to one gateway."""
        key = (p, gw_local)
        row = self._pod_dist_to_gw.get(key)
        if row is None:
            row = self._pod(p).view.topology.hop_distances_to(gw_local)
            self._pod_dist_to_gw[key] = row
        return row

    def _dist_from_gateway(self, p: int, gw_local: int) -> list[int]:
        key = (p, gw_local)
        row = self._pod_dist_from_gw.get(key)
        if row is None:
            row = self._pod(p).view.topology.hop_distances_from(gw_local)
            self._pod_dist_from_gw[key] = row
        return row

    def _nearest_gateway(self, p: int, node: int) -> int:
        """The pod-``p`` gateway nearest to ``node`` (global id), measured
        node->gateway; ties break on gateway order (pod-locally symmetric).
        Memoized per (pod, node): bulk All-to-Alls resolve the same source
        for every remote destination, and the underlying per-gateway BFS
        rows are themselves shared through :meth:`_dist_to_gateway`."""
        got = self._nearest_cache.get((p, node))
        if got is not None:
            return got
        ctx = self._pod(p)
        nl = ctx.view.to_local[node]
        best, best_d = None, None
        for gi, gl in enumerate(ctx.gateways_local):
            d = self._dist_to_gateway(p, gl)[nl]
            if d < 0:
                continue
            if best_d is None or d < best_d:
                best, best_d = gi, d
        if best is None:
            raise HierarchyError(f"node {node} cannot reach pod {p} gateways")
        got = ctx.gateways[best]
        self._nearest_cache[(p, node)] = got
        return got

    def _reachable_gateways(self, egress: int, q: int) -> list[tuple[int, int, int]]:
        """Pod-``q`` gateways reachable from global gateway ``egress`` over
        the boundary fabric: [(bdist, local gateway index, global id)],
        sorted — the deterministic candidate list for ingress selection.
        Memoized: bulk collectives query the same (egress, pod) pair for
        thousands of chunks."""
        got = self._reach_cache.get((egress, q))
        if got is not None:
            return got
        bview = self._boundary()
        bl = bview.to_local
        ctx = self._pod(q)
        out = []
        el = bl.get(egress)
        if el is not None:
            row = self._bdist_row(el)
            for gi, g in enumerate(ctx.gateways):
                j = bl.get(g)
                if j is not None and row[j] >= 0:
                    out.append((row[j], gi, g))
        out.sort()
        if not out:
            err = (SketchInfeasibleError if self.sketch is not None
                   else HierarchyError)
            raise err(
                f"no pod-{q} gateway reachable from gateway {egress} over "
                f"the boundary fabric"
            )
        self._reach_cache[(egress, q)] = out
        return out

    def _pipeline_safe(self, involved: list[int]) -> bool:
        """Pipelining overlaps the inter phase with intra/scatter phases in
        time; that is congestion-safe only when the boundary fabric shares
        no links with the involved pods' internal fabrics."""
        blinks = set(self._boundary().links)
        for p in involved:
            if blinks & set(self._pod(p).view.links):
                return False
        return True

    def _dest_pod_buckets(self, c: Condition) -> dict[int, list[int]]:
        """``{pod: [dests in pod]}`` for one condition's destination set,
        memoized by the frozenset's identity (guarded against id reuse).
        Bounded: a long-lived synthesizer fed fresh condition objects every
        call (per-step re-planning) must not accumulate dead dest sets."""
        if len(self._dest_buckets) > (1 << 16):
            self._dest_buckets.clear()
        got = self._dest_buckets.get(id(c.dests))
        if got is None or got[0] is not c.dests:
            part = self.topology.partition
            buckets: dict[int, list[int]] = {}
            for d in c.dests:
                buckets.setdefault(part[d], []).append(d)
            got = (c.dests, buckets)
            self._dest_buckets[id(c.dests)] = got
        return got[1]

    # -- phase synthesis helpers -------------------------------------------

    def _project_preload(
        self, cols: TransferColumns | None, view: TopologyView,
    ) -> TransferColumns | None:
        """Project a full-fabric occupancy schedule into one phase's
        sub-topology view: keep the transfers riding the view's links,
        relabeled into local ids. The TEN only consults (link, start, end)
        when committing occupancy, but endpoints are relabeled too so the
        block is a well-formed schedule on the sub-topology (a link kept by
        the view has both endpoints in it by construction)."""
        if cols is None or not len(cols):
            return None
        l2l = np.full(self.topology.num_links, -1, np.int64)
        l2l[np.asarray(view.links, np.int64)] = np.arange(len(view.links))
        keep = l2l[cols.link] >= 0
        if not keep.any():
            return None
        n2l = np.full(self.topology.num_nodes, -1, np.int64)
        n2l[np.asarray(view.nodes, np.int64)] = np.arange(len(view.nodes))
        return TransferColumns(
            cols.chunk[keep],
            l2l[cols.link[keep]].astype(np.int32),
            n2l[cols.src[keep]].astype(np.int32),
            n2l[cols.dst[keep]].astype(np.int32),
            cols.start[keep], cols.end[keep], cols.reduce[keep],
        )

    def _synthesize_local(
        self, sub: Topology, conds: list[Condition], *, kind: str,
        cacheable: bool, replicate: bool = False,
        preload: TransferColumns | None = None,
        pipeline: str | bool = "auto",
    ) -> CollectiveAlgorithm:
        """Synthesize a phase on its (sub-)topology, through the registry
        when one is attached so isomorphic pods (equal sub-topology
        fingerprints + equal condition signatures) share one plan. The
        registry key carries the sub-topology's partition fingerprint: a
        flat plan synthesized for an unpartitioned view of the same fabric
        must never be served for a partitioned (recursive) view.

        ``replicate`` turns on the engine's path-replication fast path —
        used in the sequential (scale) regime, where phase traffic is bulk
        runs of identical conditions and schedule tightness is already
        bounded by the phase barriers; the pipelined regime keeps the full
        per-chunk search for the tightest makespans.

        ``preload`` is pre-existing link occupancy (sub-topology-local
        columns) the phase must schedule around — chunk-granular
        cross-phase pipelining. A preload every condition's release
        already clears (min release >= last occupied instant) is dropped:
        such a phase cannot collide with it. Phases with a *uniform*
        nonzero release are synthesized canonically at release 0 and
        shifted back — the canonical sub-problem is literally the
        release-0 phase, so isomorphic pods keep sharing one registry
        entry even behind a chunk-granular junction. Phases that keep a
        preload or carry heterogeneous (run-specific, e.g.
        arrival-derived) releases bypass the registry entirely: their
        schedules are tied to this run's absolute clock, so caching them
        would only churn the LRU without ever hitting."""
        if not conds:
            return CollectiveAlgorithm(sub, [], [], name=kind)
        if preload is not None and not len(preload):
            preload = None
        releases = [c.release for c in conds]
        uniform = all(r == releases[0] for r in releases)
        if preload is not None \
                and min(releases) >= float(preload.end.max()) - 1e-9:
            preload = None
        shift = 0.0
        if preload is None and uniform and releases[0] > 0.0:
            shift = releases[0]
            conds = [replace(c, release=0.0) for c in conds]
        cacheable = cacheable and preload is None and uniform
        if self.registry is None or not cacheable:
            alg = self._phase_algorithm(sub, conds, kind, replicate,
                                        preload, pipeline=pipeline)
        else:
            def synth(_group):
                return self._phase_algorithm(sub, conds, kind, replicate,
                                             None, pipeline=pipeline)

            # the phase key carries the resolved gateway strategy and the
            # sketch fingerprint: an inter phase routed round-robin must
            # never satisfy a TE or sketch-constrained request for the same
            # sub-fabric/conditions (and vice versa). Explicitly-sequential
            # recursion (pipeline=False — the repair-friendly regime) is
            # marked too: its nested schedules differ from the auto
            # regime's, and the marker is appended only when forced so
            # every pre-existing key stays bit-identical
            sk = self.sketch
            params = (sub.partition_fingerprint(), _signature(conds),
                      replicate, self._effective_strategy(),
                      sk.fingerprint() if sk is not None else None)
            if pipeline is False:
                params = (*params, "seq")
            alg = self.registry.get_or_synthesize(
                sub, f"hier:{kind}", range(len(sub.npus)), synth,
                params=params,
            )
        if shift:
            alg = CollectiveAlgorithm(
                sub, alg.conditions, alg.columns.shifted(shift),
                name=alg.name,
                phase_spans=[(n, lo + shift, hi + shift)
                             for n, lo, hi in alg.phase_spans])
        return alg

    def _phase_algorithm(
        self, sub: Topology, conds: list[Condition], kind: str,
        replicate: bool, preload: TransferColumns | None = None,
        pipeline: str | bool = "auto",
    ) -> CollectiveAlgorithm:
        """One phase's schedule: recursively through a nested
        :class:`HierarchicalSynthesizer` when the sub-topology itself
        carries a partition the conditions span (pods-of-pods — the intra
        and scatter phases of a rack -> pod -> plane fabric decompose into
        per-rack plans, a pod boundary phase, and rack scatters), else flat
        engine synthesis. A nested :class:`HierarchyError` (missing
        gateways, unreachable sub-pods, degenerate sub-partition, a
        sequential nested regime that cannot honor ``preload``) falls
        back to flat synthesis of the phase — never a wrong plan.

        ``preload`` (sub-local columns) recurses with the conditions: the
        nested composition re-projects it into each of its own phases, so
        depth>=2 fabrics overlap preloaded traffic with their rack-level
        phases instead of stalling behind a flat fallback."""
        if sub.partition is not None:
            nested = self._nested_for(sub)
            if nested.spans_conditions(conds):
                try:
                    return nested.spanning(conds, name=kind,
                                           pipeline=pipeline,
                                           preload_cols=preload,
                                           replicate=replicate)
                except HierarchyError:
                    pass
        # >>> copy fix: a local phase its sub-fabric cannot connect
        # A degraded fabric (plan repair) can cut a phase's sub-fabric while
        # the whole fabric still connects the group; flat synthesis of the
        # phase would then stop in path finding on a bare AssertionError.
        # It is a HierarchyError: the engine's auto route synthesizes the
        # collective flat instead, as cold synthesis on that fabric does.
        hops = sub.hop_matrix()
        for c in conds:
            srcs = sorted(c.srcs) if isinstance(c, ReduceCondition) else [c.src]
            dests = sorted(c.dests)
            if hops is not None:
                connected = bool(np.isfinite(hops[np.ix_(srcs, dests)]).all())
            else:
                connected = all(bool((sub.hop_distances_np(s)[dests] >= 0).all())
                                for s in srcs)
            if not connected:
                raise HierarchyError(
                    f"{kind}: {sub.name} does not connect chunk {c.chunk}'s "
                    f"endpoints")
        pre = None
        # <<< copy fix
        if preload is not None and len(preload):
            pre = CollectiveAlgorithm(sub, [], preload, name="preload")
        return self.engine.synthesize(conds, name=kind, topology=sub,
                                      replicate=replicate, preload=pre)

    def _nested_for(self, sub: Topology) -> "HierarchicalSynthesizer":
        """The nested synthesizer over one partitioned pod sub-topology.
        Shares this synthesizer's registry, so per-rack plans are cached
        across isomorphic racks of every pod at every level."""
        ent = self._nested.get(id(sub))
        if ent is None or ent[0] is not sub:
            eng = SynthesisEngine(sub, registry=self.registry)
            h = HierarchicalSynthesizer(eng)
            # the strategy recurses (a heterogeneous rack boundary inside a
            # pod engages TE there too); the sketch does NOT — its node and
            # link ids are top-level-global and constrain only the
            # top-level inter-pod phase
            h.gateway_strategy = self.gateway_strategy
            ent = (sub, h)
            self._nested[id(sub)] = ent
        # plan capture recurses: a pods-of-pods spanning records its nested
        # per-pod compositions too, so repair can patch a damaged rack
        # without re-spanning the whole pod. Synced on every lookup (the
        # nested synthesizer is memoized, the hook is per-plan() call).
        ent[1].engine._capture = self.engine._capture
        return ent[1]

    # -- collectives --------------------------------------------------------

    def spanning(
        self, conds: list[Condition], *, pipeline: str | bool = "auto",
        name: str = "pccl_hier_spanning",
        preload_cols: TransferColumns | None = None,
        replicate: bool = False,
    ) -> CollectiveAlgorithm:
        """Hierarchically synthesize an *arbitrary* pod-spanning condition
        set: the generic decomposition the named collectives build on, and
        the re-entry point of the pods-of-pods recursion (a partitioned pod
        sub-topology's phase conditions come back through here).

        Per condition: destinations in the source's pod (plus the chunk's
        egress gateway) resolve in that pod's intra phase; the inter phase
        multicasts the chunk from its egress gateway to one ingress gateway
        per remote destination pod over the boundary fabric; per-pod
        scatter phases deliver arrived chunks to their in-pod destinations.

        Gateway selection follows :meth:`_effective_strategy`: under the
        traffic engineer each (chunk, src-pod, dst-pods) demand is assigned
        the (egress, ingress, boundary path) tree minimizing peak link
        busy-time (with the legacy round-robin assignment adopted wholesale
        if it models strictly better — the never-worse guarantee); the
        legacy path round-robins egress per source pod and ingress over the
        reachable candidates. Both are deterministic, and the per-gateway
        load histograms stay pod-position-independent on symmetric fabrics,
        so isomorphic pods keep sharing one registry-cached plan per phase
        kind.

        ``preload_cols`` is pre-existing occupancy on *this* fabric (global
        coordinates) every phase must schedule around — the chunk-granular
        All-Reduce junction passes the Reduce-Scatter schedule here so the
        gather half can overlap it per chunk on the shared links. Requires
        the pipelined regime (sequential per-pod plans are canonically
        timed from 0 and cannot avoid absolute-clock occupancy).

        ``replicate`` forces the engine's path-replication fast path for
        every phase even below the forced-pipeline size threshold — the
        pods-of-pods recursion passes it down so a forced-pipeline outer
        fabric keeps bulk-run replication inside its (small) pods too."""
        part = self.topology.partition
        if part is None:
            raise HierarchyError(f"{self.topology.name}: no partition set")
        pods: set[int] = set()
        chunks: set[int] = set()
        dest_objs: dict[int, frozenset] = {}
        for c in conds:
            pods.add(part[c.src])
            pods.update(self._dest_pod_buckets(c))
            dest_objs.setdefault(id(c.dests), c.dests)
            if c.chunk in chunks:
                raise HierarchyError(
                    f"duplicate chunk id {c.chunk} in spanning conditions")
            chunks.add(c.chunk)
        if -1 in pods:
            raise HierarchyError(
                "condition endpoints include devices owned by no pod")
        unowned = [n for n in self.topology.npus if part[n] == -1]
        if unowned:
            # an un-podded NPU may sit on the only path between two pod
            # members (no phase view would include it), silently
            # disconnecting a pod view — refuse, the caller falls back flat
            raise HierarchyError(
                f"NPUs {unowned} belong to no pod: un-podded devices can "
                "carry pod-internal connectivity no phase view includes")
        involved = sorted(pods)
        if len(involved) < 2:
            raise HierarchyError("conditions do not span pods")
        for p in involved:
            if not self.topology.gateways(p):
                raise HierarchyError(f"pod {p} has no gateway NPUs")

        use_te = self._effective_strategy() == "te"

        # per-chunk routing: egress gateway + one ingress gateway per
        # destination pod — min-max link-load TE assignment over the
        # boundary fabric, or legacy round-robin by the chunk's ordinal
        # within its source pod
        seen: dict[int, int] = {}
        egress: dict[int, int] = {}
        ingress: dict[tuple[int, int], int] = {}
        dest_pods: dict[int, list[int]] = {}
        by_src_pod: dict[int, list[Condition]] = {p: [] for p in involved}
        by_dst_pod: dict[int, list[Condition]] = {p: [] for p in involved}
        demands: list[tuple[Condition, int, list[int], int]] = []
        for c in conds:
            p = part[c.src]
            by_src_pod[p].append(c)
            k = seen.get(p, 0)
            seen[p] = k + 1
            qs = sorted(q for q in self._dest_pod_buckets(c) if q != p)
            dest_pods[c.chunk] = qs
            if not qs:
                continue  # same-pod condition: intra phase handles it fully
            for q in qs:
                by_dst_pod[q].append(c)
            if use_te:
                demands.append((c, p, qs, k))
                continue
            gws = self._pod(p).gateways
            egress[c.chunk] = gws[k % len(gws)]
            for q in qs:
                cand = self._reachable_gateways(egress[c.chunk], q)
                ingress[(c.chunk, q)] = cand[k % len(cand)][2]
        if use_te:
            self._assign_te(demands, egress, ingress)

        def intra_conds(p, ctx):
            out = []
            to_local = ctx.view.to_local
            for c in by_src_pod[p]:
                dests = set(self._dest_pod_buckets(c).get(p, ()))
                e = egress.get(c.chunk)
                if e is not None:
                    dests.add(e)
                dests.discard(c.src)
                if not dests:
                    continue
                dests.add(c.src)
                out.append(Condition(
                    c.chunk, to_local[c.src],
                    frozenset(to_local[d] for d in dests),
                    bytes=c.bytes, release=c.release, tag="hier_intra",
                ))
            return out

        def inter_conds(bview):
            out = []
            to_local = bview.to_local
            for c in conds:
                e = egress.get(c.chunk)
                if e is None:
                    continue
                dests = {ingress[(c.chunk, q)] for q in dest_pods[c.chunk]}
                dests.discard(e)
                if not dests:
                    continue
                # the release rides every phase: a chunk whose source IS its
                # egress gateway may reach the inter phase with no intra
                # barrier before it, so dropping the release here would
                # schedule the boundary transfer before the chunk exists
                out.append(Condition(
                    c.chunk, to_local[e],
                    frozenset(to_local[d] for d in dests),
                    bytes=c.bytes, release=c.release, tag="hier_inter",
                ))
            return out

        def scatter_conds(q, ctx):
            out = []
            to_local = ctx.view.to_local
            for c in by_dst_pod[q]:
                src = ingress[(c.chunk, q)]
                dests = set(self._dest_pod_buckets(c).get(q, ()))
                dests.discard(src)
                if not dests:
                    continue
                dests.add(src)
                out.append(Condition(
                    c.chunk, to_local[src],
                    frozenset(to_local[d] for d in dests),
                    bytes=c.bytes, release=c.release, tag="hier_scatter",
                ))
            return out

        endpoints = {c.src for c in conds}
        for dests in dest_objs.values():
            endpoints |= dests
        return self._compose(
            name, conds, involved, intra_conds, inter_conds, scatter_conds,
            pipeline=pipeline, group_size=len(endpoints),
            arrival_node=egress,
            ingress_of=lambda g, q: ingress.get((g, q)),
            preload_cols=preload_cols, force_replicate=replicate,
        )

    def all_gather(
        self, group, *, bytes: float = 1.0, chunks_per_npu: int = 1,
        ids: ChunkIds | None = None, pipeline: str | bool = "auto",
    ) -> CollectiveAlgorithm:
        """Hierarchical All-Gather: intra-pod all-gather (plus delivery to
        the chunk's egress gateway), gateway exchange across the boundary
        fabric (one multicast condition per chunk, fanning out to one
        ingress gateway per remote pod), then per-pod scatter of the arrived
        remote chunks — the :meth:`spanning` decomposition of the all-gather
        condition set."""
        group = list(group)
        self._require(group)
        conds = cnd.all_gather(group, ids=ids or ChunkIds(), bytes=bytes,
                               chunks_per_npu=chunks_per_npu)
        return self.spanning(conds, pipeline=pipeline,
                             name="pccl_hier_all_gather")

    def all_to_all(
        self, group, *, bytes: float = 1.0, chunks_per_pair: int = 1,
        ids: ChunkIds | None = None, pipeline: str | bool = "auto",
    ) -> CollectiveAlgorithm:
        """Hierarchical All-to-All: same-pod chunks resolve inside their
        pod's intra phase; cross-pod chunks ride source -> nearest egress
        gateway -> boundary fabric -> ingress gateway nearest the
        destination -> destination."""
        group = list(group)
        involved = self._require(group)
        conds = cnd.all_to_all(group, ids=ids or ChunkIds(), bytes=bytes,
                               chunks_per_pair=chunks_per_pair)
        part = self.topology.partition

        dest_of = {c.chunk: next(iter(c.dests)) for c in conds}
        egress: dict[int, int] = {}
        ingress: dict[int, int] = {}
        nearest: dict[int, int] = {}  # src -> egress gateway, memoized
        # Gateway strategy per ordered pod pair: on densely-connected
        # boundary fabrics (every remote gateway reachable — the DCI-switch
        # case) pair (p, q) traffic cycles through aligned (egress, ingress)
        # gateway pairs — chunk k of the pair rides gateway pair
        # (r + k) mod G, with r the relative pod index. That balances every
        # up/downlink while collapsing the inter phase to G distinct
        # endpoint pairs per pod pair (long path-replication runs instead
        # of one search per chunk), and the per-gateway histograms are
        # pod-position-independent, so per-pod plans still registry-share.
        # Sparse boundary fabrics (plane-partitioned tori, where only the
        # aligned gateway is reachable) fall back to nearest-gateway
        # selection per chunk.
        pair_dense: dict[tuple[int, int], bool] = {}
        pair_ord: dict[tuple[int, int], int] = {}

        strategy = self._effective_strategy()
        use_aligned = strategy == "aligned"
        use_te = strategy == "te"
        use_rr = strategy == "round_robin"
        seen: dict[int, int] = {}  # per-source-pod cross-pod chunk ordinal
        demands: list[tuple[Condition, int, int, int, int]] = []

        def _pair_dense(p: int, q: int) -> bool:
            if not use_aligned:
                return False
            got = pair_dense.get((p, q))
            if got is None:
                gq = self._pod(q).gateways
                cand = self._reachable_gateways(self._pod(p).gateways[0], q)
                got = pair_dense[(p, q)] = len(cand) == len(gq)
            return got

        # bucket by source/destination pod in one pass: the per-pod phase
        # builders then touch only their own conditions instead of scanning
        # the full million-condition list once per pod (O(P * conds))
        by_src_pod: dict[int, list[Condition]] = {p: [] for p in involved}
        by_dst_pod: dict[int, list[Condition]] = {p: [] for p in involved}
        num_pods = self.topology.num_pods
        for c in conds:
            d = dest_of[c.chunk]
            p, q = part[c.src], part[d]
            by_src_pod[p].append(c)
            if p == q:
                continue
            by_dst_pod[q].append(c)
            k2 = seen.get(p, 0)
            seen[p] = k2 + 1
            if use_te:
                demands.append((c, p, q, d, k2))
                continue
            if use_rr:
                gws = self._pod(p).gateways
                e = gws[k2 % len(gws)]
                egress[c.chunk] = e
                cand = self._reachable_gateways(e, q)
                ingress[c.chunk] = cand[k2 % len(cand)][2]
                continue
            if _pair_dense(p, q):
                k = pair_ord.get((p, q), 0)
                pair_ord[(p, q)] = k + 1
                r = (q - p) % num_pods
                gp = self._pod(p).gateways
                gq = self._pod(q).gateways
                egress[c.chunk] = gp[(r + k) % len(gp)]
                ingress[c.chunk] = gq[((num_pods - r) + k) % len(gq)]
                continue
            e = nearest.get(c.src)
            if e is None:
                e = nearest[c.src] = self._nearest_gateway(p, c.src)
            egress[c.chunk] = e
            i = self._ingress_cache.get((e, d))
            if i is None:
                cand = self._reachable_gateways(e, q)
                ctxq = self._pod(q)
                dl = ctxq.view.to_local[d]
                best = min(
                    cand,
                    key=lambda t: (t[0], self._dist_from_gateway(
                        q, ctxq.gateways_local[t[1]])[dl], t[1]),
                )
                i = self._ingress_cache[(e, d)] = best[2]
            ingress[c.chunk] = i
        if use_te:
            self._assign_te_a2a(demands, egress, ingress)

        def intra_conds(p, ctx):
            out = []
            to_local = ctx.view.to_local
            for c in by_src_pod[p]:
                d = dest_of[c.chunk]
                target = d if part[d] == p else egress[c.chunk]
                if target == c.src:
                    continue
                out.append(Condition(
                    c.chunk, to_local[c.src],
                    frozenset([to_local[target]]),
                    bytes=bytes, tag="hier_intra",
                ))
            return out

        def inter_conds(bview):
            out = []
            to_local = bview.to_local
            for c in conds:
                e = egress.get(c.chunk)
                if e is None:
                    continue
                out.append(Condition(
                    c.chunk, to_local[e],
                    frozenset([to_local[ingress[c.chunk]]]),
                    bytes=bytes, tag="hier_inter",
                ))
            return out

        def scatter_conds(q, ctx):
            out = []
            to_local = ctx.view.to_local
            for c in by_dst_pod[q]:
                d = dest_of[c.chunk]
                src = ingress[c.chunk]
                if src == d:
                    continue
                out.append(Condition(
                    c.chunk, to_local[src],
                    frozenset([to_local[d]]),
                    bytes=bytes, tag="hier_scatter",
                ))
            return out

        return self._compose(
            "pccl_hier_all_to_all", conds, involved, intra_conds,
            inter_conds, scatter_conds, pipeline=pipeline,
            group_size=len(group), arrival_node=egress,
            ingress_of=lambda g, q: ingress.get(g),
        )

    # -- reductions (per-phase time reversal, paper §4.5 x TACOS) -----------

    def _reversed(self) -> "HierarchicalSynthesizer":
        """The hierarchical synthesizer over the link-reversed fabric.

        ``Topology.reversed()`` carries partition metadata (pod membership
        and therefore gateways are direction-agnostic), so the reversed
        fabric exposes the same pod/boundary decomposition with every link
        flipped — the sub-problem space reduction synthesis runs in. The
        reversed engine shares this engine's registry, so per-pod broadcast
        plans on reversed pod sub-topologies are cached and reused across
        pods and across calls exactly like the forward ones."""
        if self._rev_hier is None:
            rev_eng = SynthesisEngine(self.engine.reversed_topology(),
                                      registry=self.registry)
            self._rev_hier = HierarchicalSynthesizer(rev_eng)
            self._rev_hier.gateway_strategy = self.gateway_strategy
            # link ids carry over between orientations, so the sketch's
            # exclusions and affinities mean the same hardware there
            self._rev_hier.sketch = self.sketch
        return self._rev_hier

    @staticmethod
    def _check_in_forest(alg: CollectiveAlgorithm) -> None:
        """A reduction schedule is sound only if it is an in-forest per
        chunk: every device forwards its accumulated partial at most once
        (the validation oracle's ``sent_reduce`` rule). The reversed
        hierarchical broadcast guarantees this whenever its per-chunk phase
        trees are node-disjoint except at the gateway stitch points — true
        for the supported fabric families; on an exotic partition where a
        boundary route threads a second gateway of some pod, fail over to
        flat synthesis instead of emitting an invalid plan."""
        cols = alg.columns
        n = len(cols)
        if not n:
            return
        nn = alg.topology.num_nodes
        keys = cols.chunk * nn + cols.src
        if len(np.unique(keys)) != n:
            raise HierarchyError(
                "reversed composition is not an in-forest (some device "
                "would forward its partial twice); falling back to flat "
                "reduction synthesis"
            )

    def reduce_scatter(
        self, group, *, bytes: float = 1.0, chunks_per_npu: int = 1,
        ids: ChunkIds | None = None, pipeline: str | bool = "auto",
    ) -> CollectiveAlgorithm:
        """Hierarchical Reduce-Scatter: the time-reversal of a hierarchical
        All-Gather on the reversed fabric (TACOS' reverse-topology trick,
        applied per phase through the shared pipeline).

        In the reversed (broadcast) direction, each owner multicasts its
        chunk to every contributor: an intra phase in the owner's pod, a
        gateway exchange over the reversed boundary fabric, and per-pod
        scatters — each phase registry-shared across isomorphic pods.
        Reversing the composed schedule turns the scatter phases into
        leaf partial-reductions (pod members fold into their ingress
        gateway), the inter phase into the boundary reduce, and the intra
        phase into the final fold onto the owner. Chunk ids correspond
        positionally: chunk ``i`` is owned by ``group[i // chunks_per_npu]``
        in both condition builders."""
        group = list(group)
        self._require(group)
        rconds = cnd.reduce_scatter(group, ids=ChunkIds(), bytes=bytes,
                                    chunks_per_npu=chunks_per_npu)
        rev = self._reversed()
        bcast = rev.all_gather(group, bytes=bytes,
                               chunks_per_npu=chunks_per_npu,
                               pipeline=pipeline)
        alg = time_reversed(self.topology, bcast, rconds,
                            name="pccl_hier_reduce_scatter")
        self._check_in_forest(alg)
        return renumber_chunks(alg, ids)

    def all_reduce(
        self, group, *, bytes: float = 1.0, ids: ChunkIds | None = None,
        pipeline: str | bool = "auto",
    ) -> CollectiveAlgorithm:
        """Hierarchical All-Reduce: hierarchical Reduce-Scatter then
        hierarchical All-Gather (paper §4.5), composed on one clock through
        :class:`PhasePlan`. Both sub-collectives draw chunk ids from 0 in
        group order, so chunk ``i`` is reduced onto — and then gathered
        from — ``group[i]``.

        In the pipelined regime the RS -> AG junction is *chunk-granular*:
        each chunk's gather half is released at that chunk's own
        reduce-completion time, and the gather phases are synthesized with
        the Reduce-Scatter schedule preloaded as occupancy (RS and AG ride
        the same links — time reversal preserves link ids), so early
        chunks fan out while late chunks are still reducing and no link is
        double-booked. The per-chunk release envelope is recorded as an
        ``"all_gather/@release"`` provenance span. In the sequential
        regime the All-Gather is floor-shifted to the Reduce-Scatter's end
        (the classic barrier): every per-pod plan stays canonically timed
        and registry-shareable."""
        group = list(group)
        involved = self._require(group)
        if pipeline == "auto":
            pipelined = (len(group) <= _AUTO_PIPELINE_MAX_GROUP
                         and self._pipeline_safe(involved))
        else:
            pipelined = bool(pipeline)
        rs = self.reduce_scatter(group, bytes=bytes, pipeline=pipeline)
        ar_conds = [
            ReduceCondition(c.chunk, c.srcs, c.srcs, bytes=bytes)
            for c in rs.conditions
        ]
        if not pipelined:
            ag = self.all_gather(group, bytes=bytes, pipeline=pipeline)
            plan = PhasePlan(
                phases=[
                    PhaseSpec("reduce_scatter", algorithm=rs),
                    PhaseSpec("all_gather", algorithm=ag,
                              after=("reduce_scatter",)),
                ],
                conditions=ar_conds,
                name="pccl_hier_all_reduce",
            )
            return renumber_chunks(self.engine.synthesize_plan(plan), ids)

        # per-chunk reduce-completion times: the gather release vector
        done: dict[int, float] = {c.chunk: 0.0 for c in rs.conditions}
        cols = rs.columns
        if len(cols):
            uc, inv = np.unique(cols.chunk, return_inverse=True)
            dmax = np.full(len(uc), -np.inf)
            np.maximum.at(dmax, inv, cols.end)
            for ck, d in zip(uc.tolist(), dmax.tolist()):
                done[ck] = max(done[ck], d)
        ag_conds = [
            Condition(c.chunk, next(iter(c.dests)), frozenset(group),
                      bytes=bytes, release=done[c.chunk],
                      tag="hier_allreduce_ag")
            for c in rs.conditions
        ]
        lo = min(done.values(), default=0.0)
        hi = max(done.values(), default=0.0)
        if lo == hi:
            # degenerate release envelope (time reversal pivots every
            # chunk's completion to the RS makespan on balanced fabrics):
            # the gather half is exactly the *canonical* pipelined
            # All-Gather shifted by that instant — every per-pod plan
            # stays registry-shareable, and since all RS occupancy ends at
            # the pivot no preload is needed
            ag0 = self.spanning(
                [replace(c, release=0.0) for c in ag_conds],
                pipeline=True, name="pccl_hier_all_gather")
            ag = CollectiveAlgorithm(
                self.topology, ag_conds, ag0.columns.shifted(lo),
                name=ag0.name,
                phase_spans=[(n, a + lo, b + lo)
                             for n, a, b in ag0.phase_spans])
        else:
            ag = self.spanning(ag_conds, pipeline=True,
                               name="pccl_hier_all_gather",
                               preload_cols=cols)
        plan = PhasePlan(
            phases=[
                PhaseSpec("reduce_scatter", algorithm=rs),
                # absolutely timed via its per-chunk releases: no barrier
                PhaseSpec("all_gather", algorithm=ag),
            ],
            conditions=ar_conds,
            name="pccl_hier_all_reduce",
        )
        alg = self.engine.synthesize_plan(plan)
        if done:
            # release provenance: the junction's per-chunk floor envelope,
            # nested under the gather phase ("/" keeps it out of
            # top_phase_spans) — barrier plans never carry this entry
            alg.phase_spans.append((
                "all_gather/@release",
                min(done.values()), max(done.values()),
            ))
        return renumber_chunks(alg, ids)

    # -- stitching ----------------------------------------------------------

    def _compose(
        self, name, conds, involved, intra_conds, inter_conds, scatter_conds,
        *, pipeline, group_size, arrival_node, ingress_of,
        preload_cols=None, force_replicate=False,
    ) -> CollectiveAlgorithm:
        """Build phase-local condition sets, synthesize (registry-shared
        where canonical), and stitch through the engine's PhasePlan.

        An *explicitly* sequential request (``pipeline=False``, as opposed
        to auto-resolved) recurses sequentially: every nested (pods-of-pods)
        phase is then canonically timed and registry-cacheable at every
        level — what :mod:`repro.core.repair` plans with, so a later
        phase-local repair re-synthesizes only the damaged sub-fabric and
        registry-hits everything else. Auto-resolved sequential keeps the
        historical behaviour (nested levels re-decide by their own size)."""
        child_pipeline: str | bool = "auto" if pipeline is not False else False
        if pipeline == "auto":
            pipeline = (
                group_size <= _AUTO_PIPELINE_MAX_GROUP
                and self._pipeline_safe(involved)
            )
        elif pipeline and not self._pipeline_safe(involved):
            raise HierarchyError(
                "pipeline=True requires boundary links disjoint from pod "
                "links (the inter phase would congest pod fabrics)"
            )
        if preload_cols is not None and not pipeline:
            raise HierarchyError(
                "preloaded occupancy requires the pipelined regime "
                "(sequential per-pod plans are canonically timed from 0 "
                "and cannot schedule around absolute-clock occupancy)"
            )

        bview = self._boundary()
        # beyond the auto-pipelining size, a forced pipeline=True keeps the
        # path-replication fast path: the full per-chunk search is what
        # makes large pipelined fabrics infeasible, not the overlap itself.
        # force_replicate carries that decision down the pods-of-pods
        # recursion, whose nested group sizes are small again.
        replicate = ((not pipeline) or force_replicate
                     or group_size > _AUTO_PIPELINE_MAX_GROUP)
        phases: list[PhaseSpec] = []
        intra_names = []

        # --- intra phases (canonical, registry-shared across pods) --------
        intra_local: dict[int, CollectiveAlgorithm] = {}
        intra_maps: dict[int, dict[int, int]] = {}
        for p in involved:
            ctx = self._pod(p)
            phase_conds, cmap = _canonicalize_phase(intra_conds(p, ctx))
            alg = self._synthesize_local(
                ctx.view.topology, phase_conds, kind="intra", cacheable=True,
                replicate=replicate,
                preload=self._project_preload(preload_cols, ctx.view),
                pipeline=child_pipeline,
            )
            intra_local[p] = alg
            intra_maps[p] = cmap
            phases.append(PhaseSpec(
                f"intra:{p}", algorithm=alg, topology=ctx.view.topology,
                node_map=ctx.view.nodes, link_map=ctx.view.links,
                chunk_map=cmap,
            ))
            intra_names.append(f"intra:{p}")

        # --- inter phase ---------------------------------------------------
        b_conds, b_chunk_map = _canonicalize_phase(inter_conds(bview))
        blids = {g: l for l, g in b_chunk_map.items()}
        if pipeline:
            # release each chunk at its (lifted) arrival on the egress
            # gateway: the inter phase overlaps the intra phases, which is
            # congestion-safe because their link sets are disjoint.
            arr: dict[tuple[int, int], float] = {}
            for p in involved:
                ctx = self._pod(p)
                cm = intra_maps[p]
                nm = np.asarray(ctx.view.nodes, np.int64)
                cols = intra_local[p].columns
                if not len(cols):
                    continue
                uk, amin = _min_by_key(
                    remap_ids(cols.chunk, cm), nm[cols.dst], cols.end)
                for k, e in zip(uk.tolist(), amin.tolist()):
                    key = (int(k >> 32), int(k & 0xFFFFFFFF))
                    if key not in arr or e < arr[key]:
                        arr[key] = e
            rel_conds = []
            for c in b_conds:
                g = b_chunk_map[c.chunk]
                node = arrival_node.get(g)
                rel = arr.get((g, node), 0.0) if node is not None else 0.0
                # arrival only ever *raises* the floor — the condition may
                # carry its own (caller-imposed) release already
                rel_conds.append(
                    replace(c, release=rel) if rel > c.release else c)
            inter_alg = self._synthesize_local(
                bview.topology, rel_conds, kind="inter", cacheable=False,
                replicate=replicate,
                preload=self._project_preload(preload_cols, bview),
            )
            phases.append(PhaseSpec(
                "inter", algorithm=inter_alg, topology=bview.topology,
                node_map=bview.nodes, link_map=bview.links,
                chunk_map=b_chunk_map,
            ))
        else:
            inter_alg = self._synthesize_local(
                bview.topology, b_conds, kind="inter", cacheable=True,
                replicate=True, pipeline=child_pipeline,
            )
            phases.append(PhaseSpec(
                "inter", algorithm=inter_alg, topology=bview.topology,
                node_map=bview.nodes, link_map=bview.links,
                chunk_map=b_chunk_map, after=tuple(intra_names),
            ))

        # --- scatter phases ------------------------------------------------
        if pipeline:
            # per-chunk releases at ingress arrival; overlap with the pod's
            # intra phase is made safe by preloading it into the shared
            # sub-TEN. Arrival times come from the lifted inter transfers.
            inter_arr = _arrivals(inter_alg.transfers)
        for q in involved:
            ctx = self._pod(q)
            s_conds, s_chunk_map = _canonicalize_phase(scatter_conds(q, ctx))
            if not s_conds:
                continue
            if pipeline:
                rel_conds = []
                for c in s_conds:
                    g = s_chunk_map[c.chunk]
                    node = ingress_of(g, q)
                    rel = 0.0
                    if node is not None:
                        rel = inter_arr.get(
                            (blids.get(g, -1), bview.to_local.get(node, -1)),
                            0.0,
                        )
                    rel_conds.append(
                        replace(c, release=rel) if rel > c.release else c
                    )
                # synthesized through _synthesize_local (not a raw conds
                # PhaseSpec) so a partitioned pod recurses: rack-level
                # phases overlap the arriving DCI traffic per chunk via
                # the ingress-arrival releases, with the pod's own intra
                # transfers (plus any caller preload) as occupancy the
                # nested/flat search must schedule around
                pre = [intra_local[q].columns]
                proj = self._project_preload(preload_cols, ctx.view)
                if proj is not None:
                    pre.append(proj)
                alg = self._synthesize_local(
                    ctx.view.topology, rel_conds, kind="scatter",
                    cacheable=False, replicate=replicate,
                    preload=TransferColumns.concat(pre),
                )
                phases.append(PhaseSpec(
                    f"scatter:{q}", algorithm=alg,
                    topology=ctx.view.topology, node_map=ctx.view.nodes,
                    link_map=ctx.view.links, chunk_map=s_chunk_map,
                ))
            else:
                alg = self._synthesize_local(
                    ctx.view.topology, s_conds, kind="scatter",
                    cacheable=True, replicate=True,
                    pipeline=child_pipeline,
                )
                phases.append(PhaseSpec(
                    f"scatter:{q}", algorithm=alg,
                    topology=ctx.view.topology, node_map=ctx.view.nodes,
                    link_map=ctx.view.links, chunk_map=s_chunk_map,
                    after=("inter",),
                ))

        return self.engine.synthesize_plan(
            PhasePlan(phases, list(conds), name=name)
        )


