"""Inter-pod traffic engineering: min-max link-load gateway assignment.

The hierarchical pipeline in :mod:`repro.core.hierarchy` decomposes a
pod-spanning collective into intra / inter / scatter phases; every
cross-pod chunk must be pinned to an (egress gateway, ingress gateway,
boundary path) triple before the phases are synthesized. Round-robin
cycling balances *counts*, which is optimal only when every boundary link
has equal timing — on asymmetric DCI fabrics (skewed uplink counts or
non-uniform uplink bandwidths) it leaves the slow links hot while fast
uplinks idle. This module treats the selection as a load-balancing
assignment over the boundary fabric (TACCL's routing sketch applied to
the pod graph; TE-CCL's per-chunk flow objective):

* the per-chunk inter-pod **demand matrix** is collected during
  decomposition and handed to :class:`TrafficEngineer`;
* each demand is assigned greedily to the candidate triple minimizing the
  resulting **maximum link busy-time** (load is accumulated in time
  units — ``transfer_time(bytes)`` per link — so a 4x-slower uplink
  saturates 4x earlier), with deterministic tie-breaks (path cost, then
  intra-pod distance, then gateway index) so plans are reproducible and
  registry-cacheable;
* small instances get an **exact refinement pass** (branch-and-bound over
  the per-demand candidate trees) that certifies the min-max optimum
  within the candidate space;
* the greedy result is **never worse than round-robin**: callers hand the
  legacy round-robin assignment to :meth:`TrafficEngineer.better_of`,
  which keeps whichever assignment has the lower modeled peak load.

:class:`CommSketch` carries operator constraints (TACCL-style
communication sketches) that act on the same assignment as hard
constraints: gateway affinities restrict the candidate gateways per pod,
node/link exclusions remove hardware (e.g. a storage plane) from the
boundary fabric entirely, and per-pod port caps bound how many distinct
gateways a pod may use. An unsatisfiable sketch raises
:class:`SketchInfeasibleError` — never a silent fallback to an
unconstrained plan.
"""

from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field

from repro_torch.core.errors import PCCLError
from repro_torch.topology.topology import Topology

__all__ = ["CommSketch", "SketchInfeasibleError", "TrafficEngineer"]

# beyond this many demands the exact pass is skipped (greedy + local
# refinement only); below it, branch-and-bound runs with this node budget
_EXACT_MAX_DEMANDS = 24
_EXACT_NODE_BUDGET = 20000
# local-search refinement rounds (each round moves at most one demand off
# the bottleneck link; terminates early at a fixpoint)
_REFINE_ROUNDS = 64


class SketchInfeasibleError(PCCLError, ValueError):
    """A :class:`CommSketch` constraint cannot be satisfied on this fabric
    (affinity names a non-gateway, exclusions disconnect a pod pair, a port
    cap starves a demand). Deliberately NOT a ``HierarchyError``: the
    engine's auto route falls back to *flat* synthesis on ``HierarchyError``,
    which would silently ignore the sketch (the hard end of the
    :class:`repro.core.errors.PCCLError` fallback contract)."""


def _norm_pairs(mapping) -> tuple:
    """dict-or-pairs -> sorted ((key, normalized value), ...) tuple."""
    if mapping is None:
        return ()
    items = mapping.items() if hasattr(mapping, "items") else mapping
    out = []
    for k, v in items:
        if isinstance(v, (int, float)):
            out.append((int(k), int(v)))
        else:
            out.append((int(k), tuple(sorted(int(x) for x in v))))
    return tuple(sorted(out))


@dataclass(frozen=True)
class CommSketch:
    """Operator constraints on inter-pod gateway assignment (hard).

    ``gateway_affinity``
        ``{pod: iterable of gateway node ids}`` — the pod's egress/ingress
        traffic may only use these gateways. Ids are global (top-level
        fabric) node ids and must be actual gateways of that pod.
    ``exclude_nodes`` / ``exclude_links``
        Global node/link ids removed from the boundary fabric before any
        inter-pod routing — the "keep DP traffic off the storage plane"
        knob. Excluding a node drops every boundary link touching it.
    ``max_pod_ports``
        ``{pod: k}`` — the pod uses at most ``k`` distinct gateways across
        the whole assignment (a port/bandwidth cap). The engineer opens
        ports greedily and re-uses open ones once the cap is reached.

    Instances are immutable and order-normalized, so equal constraints
    always produce the same :meth:`fingerprint` — the registry key
    component that keeps sketch-constrained plans from ever being served
    to unconstrained requests (or vice versa).
    """

    gateway_affinity: tuple = ()
    exclude_nodes: frozenset = frozenset()
    exclude_links: frozenset = frozenset()
    max_pod_ports: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "gateway_affinity",
                           _norm_pairs(self.gateway_affinity))
        object.__setattr__(self, "max_pod_ports",
                           _norm_pairs(self.max_pod_ports))
        object.__setattr__(self, "exclude_nodes",
                           frozenset(int(n) for n in self.exclude_nodes))
        object.__setattr__(self, "exclude_links",
                           frozenset(int(l) for l in self.exclude_links))

    def allowed_gateways(self, pod: int) -> tuple[int, ...] | None:
        for p, gws in self.gateway_affinity:
            if p == pod:
                return gws
        return None

    def port_cap(self, pod: int) -> int | None:
        for p, k in self.max_pod_ports:
            if p == pod:
                return k
        return None

    @property
    def excludes_hardware(self) -> bool:
        return bool(self.exclude_nodes or self.exclude_links)

    def fingerprint(self) -> str:
        """Stable 16-hex digest of the normalized constraint set."""
        payload = repr((self.gateway_affinity,
                        tuple(sorted(self.exclude_nodes)),
                        tuple(sorted(self.exclude_links)),
                        self.max_pod_ports))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass
class _Demand:
    """One assigned demand: chunk ``key`` from pod ``p`` to dest pods
    ``qs`` with its chosen egress/ingress and the boundary links its
    multicast tree occupies (bsub-local link ids, deduplicated)."""

    key: int
    p: int
    qs: tuple[int, ...]
    nbytes: float
    egress: int = -1
    ingress: dict = field(default_factory=dict)  # q -> gateway (global id)
    links: tuple[int, ...] = ()


class TrafficEngineer:
    """Greedy min-max link-load assigner over one boundary sub-topology.

    One instance per collective call: ``load`` accumulates the busy-time
    each boundary link would carry under the assignment so far. Canonical
    egress->ingress routes (deterministic Dijkstra by (time, hops, node))
    are memoized in ``route_cache``, which callers may share across calls
    — routes depend only on the fabric, not on the load state.
    """

    def __init__(self, sub: Topology, to_local: dict[int, int], *,
                 sketch: CommSketch | None = None,
                 route_cache: dict | None = None,
                 attach_egress: dict[int, tuple[float, float]] | None = None,
                 attach_ingress: dict[int, tuple[float, float]] | None = None):
        self.sub = sub
        self.to_local = to_local
        self.sketch = sketch
        # ``attach_*`` model gateway *attachment* serialization: per gateway
        # (global id), an (alpha, beta) for a virtual link standing in for
        # the gateway's pod-side fan-in (egress role) or fan-out (ingress
        # role) — without them the assigner would pile every chunk onto the
        # fastest uplink's gateway and the intra/scatter phases would
        # serialize behind that one node. Virtual links live past the real
        # ones in the shared load vector, so refinement, simulation and the
        # never-worse guarantee all see them.
        self._attach_ab: list[tuple[float, float]] = []
        self._veg = self._index_attach(attach_egress)
        self._vin = self._index_attach(attach_ingress)
        self.load = [0.0] * (sub.num_links + len(self._attach_ab))
        self._routes = route_cache if route_cache is not None else {}
        self._w_cache: dict[float, list[float]] = {}
        self._ports_used: dict[int, set[int]] = {}
        self._demands: list[_Demand] = []
        # per-demand candidate alternatives kept for refinement/exact:
        # key -> list of (egress, {q: ingress}, links tuple, cost)
        self._alts: dict[int, list] = {}

    def _index_attach(self, attach) -> dict[int, int]:
        idx = {}
        for g in sorted(attach or ()):
            idx[g] = self.sub.num_links + len(self._attach_ab)
            self._attach_ab.append(attach[g])
        return idx

    # -- geometry -----------------------------------------------------------

    def _weights(self, nbytes: float) -> list[float]:
        w = self._w_cache.get(nbytes)
        if w is None:
            w = [l.transfer_time(nbytes) for l in self.sub.links]
            w += [a + nbytes * b for a, b in self._attach_ab]
            self._w_cache[nbytes] = w
        return w

    def route(self, e: int, i: int) -> tuple[float, tuple[int, ...]] | None:
        """Canonical cheapest path egress ``e`` -> ingress ``i`` (global
        ids) over the boundary fabric: Dijkstra on per-hop transfer time
        for unit bytes, deterministic tie-break on (time, hops, node id),
        links relaxed in id order. Returns (cost, bsub-local link ids) or
        None when unreachable."""
        key = (e, i)
        got = self._routes.get(key)
        if got is not None:
            return got if got != () else None
        el, il = self.to_local.get(e), self.to_local.get(i)
        if el is None or il is None:
            self._routes[key] = ()
            return None
        if el == il:
            self._routes[key] = (0.0, ())
            return 0.0, ()
        sub = self.sub
        dist: dict[int, tuple[float, int]] = {el: (0.0, 0)}
        prev: dict[int, tuple[int, int]] = {}  # node -> (prev node, link)
        heap = [(0.0, 0, el)]
        while heap:
            d, h, u = heapq.heappop(heap)
            if (d, h) > dist.get(u, (float("inf"), 0)):
                continue
            if u == il:
                break
            for l in sub.out_links(u):
                nd, nh = d + l.transfer_time(1.0), h + 1
                cur = dist.get(l.dst)
                if cur is None or (nd, nh) < cur:
                    dist[l.dst] = (nd, nh)
                    prev[l.dst] = (u, l.id)
                    heapq.heappush(heap, (nd, nh, l.dst))
        if il not in dist:
            self._routes[key] = ()
            return None
        links = []
        u = il
        while u != el:
            u, lid = prev[u]
            links.append(lid)
        links.reverse()
        got = (dist[il][0], tuple(links))
        self._routes[key] = got
        return got

    # -- sketch-constrained candidate sets ----------------------------------

    def _cap_filter(self, pod: int, cands: list[int]) -> list[int]:
        cap = self.sketch.port_cap(pod) if self.sketch else None
        if cap is None:
            return cands
        used = self._ports_used.get(pod, set())
        if len(used) < cap:
            return cands
        out = [g for g in cands if g in used]
        if not out:
            raise SketchInfeasibleError(
                f"pod {pod}: max_pod_ports={cap} leaves no usable gateway "
                f"for this demand")
        return out

    def _mark_ports(self, pod: int, gw: int) -> None:
        if self.sketch and self.sketch.port_cap(pod) is not None:
            self._ports_used.setdefault(pod, set()).add(gw)

    # -- assignment ---------------------------------------------------------

    def assign(self, key: int, p: int, egress_cands: list[int],
               ingress_cands: dict[int, list[int]], nbytes: float,
               ingress_tie=None) -> tuple[int, dict[int, int]]:
        """Assign one demand (chunk ``key``, source pod ``p``, one ingress
        per destination pod) to the candidate tree minimizing the resulting
        peak link busy-time. ``ingress_tie(q, gw)`` optionally supplies a
        secondary objective (e.g. intra-pod distance to the final
        destination). Returns (egress, {dest pod: ingress}) and commits the
        tree's load."""
        w = self._weights(nbytes)
        load = self.load
        qs = sorted(ingress_cands)
        best = None  # (key, egress, {q: ingress}, links tuple, cost)
        alts = []
        for ei, e in enumerate(self._cap_filter(p, egress_cands)):
            picks: dict[int, int] = {}
            tree: set[int] = set()
            ve = self._veg.get(e)
            if ve is not None:
                tree.add(ve)
            cost = 0.0
            ok = True
            for q in qs:
                bq = None
                for ii, i in enumerate(self._cap_filter(q, ingress_cands[q])):
                    r = self.route(e, i)
                    if r is None:
                        continue
                    rc, links = r
                    vi = self._vin.get(i)
                    if vi is not None:
                        links = links + (vi,)
                    peak = 0.0
                    for l in links:
                        x = load[l] + w[l]
                        if x > peak:
                            peak = x
                    tie = ingress_tie(q, i) if ingress_tie else 0
                    k2 = (peak, rc, tie, ii)
                    if bq is None or k2 < bq[0]:
                        bq = (k2, i, links, rc)
                if bq is None:
                    ok = False
                    break
                picks[q] = bq[1]
                tree.update(bq[2])
                cost += bq[3]
            if not ok:
                continue
            links = tuple(sorted(tree))
            peak = 0.0
            for l in links:
                x = load[l] + w[l]
                if x > peak:
                    peak = x
            alts.append((e, dict(picks), links, cost))
            k2 = (peak, cost, ei)
            if best is None or k2 < best[0]:
                best = (k2, e, picks, links, cost)
        if best is None:
            if self.sketch is not None:
                raise SketchInfeasibleError(
                    f"demand {key} (pod {p} -> pods {qs}): no sketch-"
                    f"feasible (egress, ingress) assignment")
            raise ValueError(
                f"demand {key} (pod {p} -> pods {qs}): no boundary route")
        _, e, picks, links, cost = best
        for l in links:
            load[l] += w[l]
        self._mark_ports(p, e)
        for q, i in picks.items():
            self._mark_ports(q, i)
        self._demands.append(_Demand(key, p, tuple(qs), nbytes, e,
                                     dict(picks), links))
        self._alts[key] = alts
        return e, picks

    def peak(self) -> float:
        return max(self.load, default=0.0)

    def assignments(self) -> list[tuple[int, int, dict[int, int]]]:
        """[(key, egress, {dest pod: ingress})] in assignment order — the
        final state after any refinement/adoption pass."""
        return [(d.key, d.egress, dict(d.ingress)) for d in self._demands]

    # -- refinement ---------------------------------------------------------

    def refine(self) -> None:
        """Improve the greedy assignment in place: an exact branch-and-bound
        pass when the instance is small enough to certify, else bounded
        local search moving demands off the bottleneck link. Both are
        deterministic and only ever lower the peak load."""
        if not self._demands:
            return
        if self.sketch is not None and self.sketch.max_pod_ports:
            # alternatives were recorded against the port-usage state at
            # assign time; retargeting could open a port past the cap
            return
        if len(self._demands) <= _EXACT_MAX_DEMANDS and self._exact():
            return
        self._local_search()

    def _retarget(self, d: _Demand, alt) -> None:
        """Re-point demand ``d`` at alternative ``alt``, updating loads."""
        w = self._weights(d.nbytes)
        for l in d.links:
            self.load[l] -= w[l]
        e, picks, links, _ = alt
        for l in links:
            self.load[l] += w[l]
        d.egress, d.ingress, d.links = e, dict(picks), links

    def _local_search(self) -> None:
        for _ in range(_REFINE_ROUNDS):
            peak = self.peak()
            if peak <= 0.0:
                return
            hot = self.load.index(peak)
            moved = False
            for d in self._demands:
                if hot not in d.links:
                    continue
                w = self._weights(d.nbytes)
                for l in d.links:
                    self.load[l] -= w[l]
                best = None
                for alt in self._alts.get(d.key, ()):
                    apeak = max((self.load[l] + w[l] for l in alt[2]),
                                default=0.0)
                    k2 = (apeak, alt[3])
                    if best is None or k2 < best[0]:
                        best = (k2, alt)
                for l in d.links:
                    self.load[l] += w[l]
                if best is not None and best[0][0] < peak \
                        and max(self.load) < peak + 1e-12:
                    # strict improvement exists and the peak is this link's
                    self._retarget(d, best[1])
                    if self.peak() < peak - 1e-12:
                        moved = True
                        break
            if not moved:
                return

    def _exact(self) -> bool:
        """Branch-and-bound over the recorded per-demand alternatives:
        certifies the min-max optimum within the candidate space for small
        pod graphs. Returns False (leaving the greedy assignment) when the
        search space or node budget is exceeded."""
        demands = self._demands
        alt_lists = []
        space = 1
        for d in demands:
            alts = self._alts.get(d.key)
            if not alts:
                return False
            alt_lists.append(alts)
            space *= len(alts)
            if space > 1 << 20:
                return False
        # residual load not owned by any recorded demand (callers only ever
        # route through assign(), so this is normally all zeros)
        w_of = {d.key: self._weights(d.nbytes) for d in demands}
        residual = list(self.load)
        for d in demands:
            w = w_of[d.key]
            for l in d.links:
                residual[l] -= w[l]
        best_peak = self.peak()
        best_choice = None
        budget = [_EXACT_NODE_BUDGET]

        # order demands by fewest alternatives first (classic B&B heuristic)
        order = sorted(range(len(demands)),
                       key=lambda k: (len(alt_lists[k]), k))

        def dfs(pos: int, load: list[float], peak: float, choice: list):
            nonlocal best_peak, best_choice
            if budget[0] <= 0 or peak >= best_peak:
                return
            if pos == len(order):
                best_peak = peak
                best_choice = list(choice)
                return
            k = order[pos]
            d = demands[k]
            w = w_of[d.key]
            scored = []
            for ai, alt in enumerate(alt_lists[k]):
                p2 = peak
                for l in alt[2]:
                    x = load[l] + w[l]
                    if x > p2:
                        p2 = x
                scored.append((p2, alt[3], ai))
            scored.sort()
            for p2, _, ai in scored:
                if p2 >= best_peak:
                    break
                if budget[0] <= 0:
                    return
                budget[0] -= 1
                alt = alt_lists[k][ai]
                for l in alt[2]:
                    load[l] += w[l]
                choice.append((k, ai))
                dfs(pos + 1, load, p2, choice)
                choice.pop()
                for l in alt[2]:
                    load[l] -= w[l]

        dfs(0, list(residual), max(residual, default=0.0), [])
        if best_choice is None or budget[0] <= 0:
            return budget[0] > 0  # exhausted budget: keep greedy, unproven
        for k, ai in best_choice:
            self._retarget(demands[k], alt_lists[k][ai])
        return True

    # -- the never-worse-than-round-robin guarantee -------------------------

    def _alternative_for(self, d: _Demand, e: int, picks: dict):
        """Express a fixed (egress, ingress) choice for demand ``d`` as an
        alternative tuple, or None when some leg has no boundary route."""
        tree: set[int] = set()
        ve = self._veg.get(e)
        if ve is not None:
            tree.add(ve)
        cost = 0.0
        for q in d.qs:
            r = self.route(e, picks[q])
            if r is None:
                return None
            tree.update(r[1])
            vi = self._vin.get(picks[q])
            if vi is not None:
                tree.add(vi)
            cost += r[0]
        return (e, dict(picks), tuple(sorted(tree)), cost)

    def simulate(self, choices) -> float:
        """Peak link busy-time a fixed assignment would produce.
        ``choices`` is [(egress, {q: ingress})], aligned with the demands
        in assignment order — the legacy round-robin selection scored under
        the same load model."""
        load = [0.0] * len(self.load)
        for d, (e, picks) in zip(self._demands, choices):
            alt = self._alternative_for(d, e, picks)
            if alt is None:
                return float("inf")
            w = self._weights(d.nbytes)
            for l in alt[2]:
                load[l] += w[l]
        return max(load, default=0.0)

    def better_of(self, rr_choices) -> bool:
        """Adopt the round-robin assignment wholesale when its modeled peak
        is strictly lower than the engineered one — the anytime guarantee
        that TE never exceeds round-robin's max inter-pod link load even
        where greedy + refinement land in a bad local optimum.
        ``rr_choices`` aligns with the demands in assignment order.
        Returns True when the round-robin assignment was adopted."""
        if rr_choices is None or len(rr_choices) != len(self._demands):
            return False
        if self.simulate(rr_choices) >= self.peak() - 1e-12:
            return False
        for d, (e, picks) in zip(self._demands, rr_choices):
            alt = self._alternative_for(d, e, picks)
            if alt is not None:
                self._retarget(d, alt)
        return True
