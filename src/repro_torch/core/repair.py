"""Fault-aware incremental plan repair for degraded fabrics.

A production fabric loses links and devices as a matter of course. PCCL's
partition tree localizes that damage: a rack-internal link failure touches
one pod's intra/scatter phases and nothing else, so re-synthesizing the
whole collective from scratch throws away every undamaged pod's schedule.
:class:`PlanRepairer` keeps the composed :class:`PhasePlan` record of a
synthesis (via the engine's plan-capture hook), and on a
:class:`DegradationEvent`:

1. derives the surviving fabric as a :meth:`Topology.degraded` view (node
   ids stable, failed links + links incident to failed devices dropped,
   partition tree carried over);
2. checks feasibility — if the surviving fabric cannot fulfil the request
   at all (a group member unreachable, a pod's sole gateway dead), raises
   :class:`FabricDegradedError` loudly, never a silently-wrong schedule;
3. classifies the damage through the partition tree (pod-internal vs
   boundary vs gateway-loss, see :class:`DamageReport`);
4. repairs *phase-locally* when the record allows it: undamaged phases are
   kept verbatim (their sub-fabrics are untouched — only the link map is
   re-indexed into the degraded fabric's compressed link ids) and damaged
   phases are re-synthesized on their degraded sub-topology views, where
   the shared registry still serves every undamaged isomorphic sub-pod
   (on a pods-of-pods fabric, a rack failure re-synthesizes one pod's
   intra phase and that pod's seven undamaged racks registry-hit their
   cached rack plans); the patched plan is re-stitched and validated;
5. falls back to a cold synthesis of the request on the degraded fabric —
   still through the shared registry — when the damage crosses what
   phase-local repair can express (a lost gateway changes every phase's
   gateway assignment; a dead group member changes the condition set; a
   pipelined record's releases are tied to the dead fabric's clock).

Phase-level registry keys stay structure-based on purpose: a degraded
sub-fabric that is structurally identical to a healthy one synthesizes the
identical phase plan, and that sharing *is* the repair speedup. The
whole-collective route keys, by contrast, carry the degradation
fingerprint (``SynthesisEngine.degradation``) on top of the degraded
topology's own structure hash, so a degraded plan can never cross-serve a
healthy fabric's request or another event's.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

try:  # scipy ships with the toolchain; degrade to BFS sweeps without it
    from scipy.sparse import csr_matrix as _sp_csr_matrix
    from scipy.sparse.csgraph import connected_components as _sp_scc
except ImportError:  # pragma: no cover
    _sp_csr_matrix = _sp_scc = None

from repro_torch.core.algorithm import CollectiveAlgorithm, TransferColumns
from repro_torch.core.conditions import Condition
from repro_torch.core.engine import PhasePlan, SynthesisEngine
from repro_torch.core.errors import FabricDegradedError
from repro_torch.core.hierarchy import HierarchyError
from repro_torch.core.request import CollectiveRequest
from repro_torch.core.traffic import SketchInfeasibleError
from repro_torch.topology.topology import Topology, TopologyView

__all__ = [
    "DamageReport",
    "DegradationEvent",
    "FabricDegradedError",
    "PlanRepairer",
    "RepairResult",
]


@dataclass(frozen=True)
class DegradationEvent:
    """One fabric-degradation event: the failed link ids and/or device
    (node) ids, normalized to sorted unique tuples."""

    failed_links: tuple = ()
    failed_npus: tuple = ()

    def __post_init__(self):
        object.__setattr__(
            self, "failed_links",
            tuple(sorted({int(l) for l in self.failed_links})))
        object.__setattr__(
            self, "failed_npus",
            tuple(sorted({int(n) for n in self.failed_npus})))

    def __bool__(self) -> bool:
        return bool(self.failed_links or self.failed_npus)

    def fingerprint(self) -> str:
        return f"L{','.join(map(str, self.failed_links))}" \
               f"|N{','.join(map(str, self.failed_npus))}"


@dataclass(frozen=True)
class DamageReport:
    """Where the damage landed, through the partition tree's eyes.

    ``pod_internal`` lists pods whose internal fabric lost a link or a
    non-gateway device; ``gateway_loss`` lists pods that lost a gateway
    NPU (every phase's gateway assignment is suspect); ``boundary`` is set
    when the inter-pod fabric itself lost a link. On an unpartitioned
    fabric everything is ``unpartitioned`` damage."""

    pod_internal: tuple = ()
    boundary: bool = False
    gateway_loss: tuple = ()
    unpartitioned: bool = False


@dataclass(frozen=True)
class RepairResult:
    """A repaired collective plus its provenance. ``strategy`` is
    ``"phases"`` (phase-local repair: ``phases_kept`` schedules survived
    verbatim, ``phases_resynthesized`` were re-synthesized on degraded
    sub-views) or ``"resynth"`` (cold synthesis on the degraded fabric,
    shared-registry warm). ``algorithm.topology`` is ``view.topology`` —
    the degraded fabric, whose node ids match the original's and whose
    link ids map back through ``view.links``."""

    algorithm: object
    view: TopologyView
    strategy: str
    event: DegradationEvent
    request: CollectiveRequest
    report: DamageReport
    phases_kept: int = 0
    phases_resynthesized: int = 0

    @property
    def topology(self) -> Topology:
        return self.view.topology


class PlanRepairer:
    """Synthesizes collectives with plan capture and repairs them against
    degradation events.

    :meth:`plan` synthesizes a request on the healthy fabric, keeping the
    composed ``PhasePlan`` record when the synthesis produced one (the
    hierarchical spanning family does; flat plans and reductions have no
    phase record and repair by resynthesis). :meth:`repair` patches a
    previously-planned request — or cold-synthesizes an unplanned one —
    onto the surviving fabric.
    """

    def __init__(self, topology: Topology, *, registry=None,
                 gateway_strategy: str = "auto", sketch=None,
                 pipeline: str | bool = "auto"):
        self.topology = topology
        self.registry = registry
        self.gateway_strategy = gateway_strategy
        self.sketch = sketch
        # regime for planned collectives: only the sequential regime's
        # canonically-timed, barrier-composed records repair phase-locally
        # (a pipelined record's releases are tied to the healthy fabric's
        # absolute clock). "auto" pipelines small groups as usual — their
        # plans then repair by resynthesis; pipeline=False trades a little
        # makespan tightness for phase-repairable records everywhere.
        self.pipeline = pipeline
        self.engine = SynthesisEngine(topology, registry=registry,
                                      gateway_strategy=gateway_strategy,
                                      sketch=sketch)
        # request fingerprint ->
        #   (request, captured PhasePlan | None, nested (result, plan) pairs)
        self._records: dict[str, tuple] = {}
        # event fingerprint -> (degraded Topology, SynthesisEngine)
        self._dengines: dict[str, tuple[Topology, SynthesisEngine]] = {}

    # -- planning (capture) --------------------------------------------------

    def plan(self, request: CollectiveRequest, *, ids=None):
        """Synthesize ``request`` on the healthy fabric, recording the
        composed phase structure for later repair.

        Drives the hierarchical synthesizer directly (bypassing the
        registry's whole-collective canonicalization, which could relabel
        the captured record into another group's coordinates); the
        per-phase registry sharing underneath is untouched. Requests the
        hierarchical route cannot take synthesize through the ordinary
        engine path and repair by resynthesis only."""
        req = request
        hier = self.engine.hierarchical()
        cap: list = []
        self.engine._capture = cap
        try:
            try:
                pl = self.pipeline
                if req.kind == "all_gather":
                    alg = hier.all_gather(list(req.group), bytes=req.bytes,
                                          chunks_per_npu=req.chunks, ids=ids,
                                          pipeline=pl)
                elif req.kind == "all_to_all":
                    alg = hier.all_to_all(list(req.group), bytes=req.bytes,
                                          chunks_per_pair=req.chunks, ids=ids,
                                          pipeline=pl)
                elif req.kind == "reduce_scatter":
                    alg = hier.reduce_scatter(list(req.group),
                                              bytes=req.bytes,
                                              chunks_per_npu=req.chunks,
                                              ids=ids, pipeline=pl)
                elif req.kind == "all_reduce":
                    alg = hier.all_reduce(list(req.group), bytes=req.bytes,
                                          ids=ids, pipeline=pl)
                else:  # reduce: no hierarchical route, no phase record
                    alg = self.engine.collective(req, ids=ids)
            except HierarchyError:
                if req.hierarchy == "always" or self.sketch is not None:
                    raise
                cap.clear()
                alg = self.engine.collective(req, ids=ids)
        finally:
            self.engine._capture = None
        record = cap[-1][0] if cap else None
        if record is not None and not self._sequential_record(record):
            # pipelined records carry run-specific absolute releases tied
            # to the healthy fabric's clock: not phase-repairable
            record = None
        # earlier captures are nested compositions (a pods-of-pods phase's
        # own per-rack spanning): kept keyed by their result algorithm, so
        # a damaged phase can be repaired *recursively* — only the damaged
        # rack re-synthesizes — instead of re-spanning the whole pod
        sub = tuple((res, pl) for pl, res in cap[:-1]
                    if self._sequential_record(pl))
        self._records[req.fingerprint()] = (req, record, sub)
        return alg

    def recorded(self, request: CollectiveRequest) -> bool:
        """True when :meth:`plan` has run for ``request`` (whether or not
        it yielded a phase-repairable record)."""
        return request.fingerprint() in self._records

    @staticmethod
    def _sequential_record(plan: PhasePlan) -> bool:
        """True iff the captured record is a sequential spanning
        composition: every phase a canonically-timed sub-topology
        algorithm, barriers via ``after`` (the inter phase waits on the
        intra phases). Only such records repair phase-locally — their
        per-phase schedules are release-0 canonical, so a re-synthesized
        replacement slots into the same barrier structure."""
        saw_after = False
        for ph in plan.phases:
            if ph.algorithm is None or ph.node_map is None \
                    or ph.link_map is None:
                return False
            if ph.preload_from or ph.floors_from or ph.floors:
                return False
            saw_after = saw_after or bool(ph.after)
        return saw_after

    # -- damage classification ----------------------------------------------

    def classify(self, event: DegradationEvent) -> DamageReport:
        """Route the event's damage through the partition tree."""
        topo = self.topology
        part = topo.partition
        if part is None:
            return DamageReport(unpartitioned=bool(event))
        boundary_ids = {l.id for l in topo.boundary_links()}
        pod_internal: set[int] = set()
        gateway_loss: set[int] = set()
        boundary = False
        for l in event.failed_links:
            if l in boundary_ids:
                boundary = True
            else:
                p = part[topo.links[l].src]
                if p < 0:
                    p = part[topo.links[l].dst]
                if p >= 0:
                    pod_internal.add(p)
                else:
                    boundary = True  # link between unassigned devices
        for n in event.failed_npus:
            p = part[n]
            if p >= 0 and n in topo.gateways(p):
                gateway_loss.add(p)
            elif p >= 0:
                pod_internal.add(p)
            else:
                boundary = True
        return DamageReport(
            pod_internal=tuple(sorted(pod_internal)), boundary=boundary,
            gateway_loss=tuple(sorted(gateway_loss)))

    # -- feasibility ---------------------------------------------------------

    def _check_feasible(self, dtopo: Topology, req: CollectiveRequest):
        """Raise :class:`FabricDegradedError` when the surviving fabric
        cannot connect the request's endpoints — the guard that makes a
        dead sole gateway fail loudly instead of synthesizing garbage."""
        group = list(req.group)
        if req.kind != "reduce" and _sp_scc is not None and dtopo.num_links:
            # all-pairs mutual reachability within the group == every
            # member in the same strongly connected component of the full
            # fabric (paths may transit non-members); one O(V+E) sweep
            # instead of an all-pairs hop matrix
            csr = dtopo.csr()
            n = dtopo.num_nodes
            graph = _sp_csr_matrix(
                (np.ones(len(csr.dst_ids)), (csr.src_ids, csr.dst_ids)),
                shape=(n, n))
            _, labels = _sp_scc(graph, directed=True, connection="strong")
            if len(set(labels[g] for g in group)) > 1:
                raise FabricDegradedError(
                    f"{dtopo.name}: surviving fabric disconnects the "
                    f"{req.kind} group (members span multiple strongly "
                    f"connected components)")
            return
        hm = dtopo.hop_matrix()
        if req.kind == "reduce":
            pairs = [(s, req.root) for s in group if s != req.root]
        else:
            pairs = None  # all-pairs within the group
        if hm is not None:
            idx = np.asarray(group, np.int64)
            if pairs is None:
                bad = ~np.isfinite(hm[np.ix_(idx, idx)])
            else:
                bad = ~np.isfinite(hm[idx, req.root])
            if bad.any():
                raise FabricDegradedError(
                    f"{dtopo.name}: surviving fabric disconnects the "
                    f"{req.kind} group (unreachable member pairs remain "
                    f"after {len(group)}-member feasibility sweep)")
            return
        for s in group:
            dist = dtopo.hop_distances_np(s)
            targets = [req.root] if pairs is not None else group
            if any(dist[t] < 0 for t in targets if t != s):
                raise FabricDegradedError(
                    f"{dtopo.name}: surviving fabric disconnects the "
                    f"{req.kind} group (node {s} cannot reach all "
                    f"required peers)")

    # -- repair --------------------------------------------------------------

    def repair(self, request: CollectiveRequest, event: DegradationEvent,
               *, ids=None, validate: str | None = "auto") -> RepairResult:
        """Repair ``request`` against ``event``: a :class:`RepairResult`
        whose algorithm fulfils, on the surviving fabric, the same
        per-chunk conditions a cold synthesis there would — or
        :class:`FabricDegradedError` when no schedule can.

        ``validate`` is the post-repair validation mode (default
        ``"auto"``: full bulk/oracle validation of the patched plan, with
        a validation miss on the phase-repair path falling back to cold
        resynthesis). ``None`` skips that final validation — for callers
        that gate validity downstream (the bench validates untimed and
        reports it as its own row), matching the cold synthesis path,
        which does not validate inline either. Feasibility checking and
        :class:`FabricDegradedError` gating are never skipped."""
        req = request
        dview = self.topology.degraded(event.failed_links, event.failed_npus)
        dtopo = dview.topology
        report = self.classify(event)

        dead = set(event.failed_npus)
        dead_members = sorted(dead & set(req.group))
        if dead_members:
            if req.kind == "reduce" and req.root in dead:
                raise FabricDegradedError(
                    f"reduce root {req.root} is among the failed devices")
            survivors = [n for n in req.group if n not in dead]
            if len(survivors) < 2:
                raise FabricDegradedError(
                    f"{req.kind}: fewer than two group members survive "
                    f"{event.fingerprint()}")
            req = req.with_group(survivors)
        self._check_feasible(dtopo, req)

        if not dead_members:
            got = self._records.get(req.fingerprint())
            if got is not None and got[1] is not None:
                result = self._repair_phases(req, got[1], got[2], event,
                                             dview, report, validate=validate)
                if result is not None:
                    return result
        alg = self._resynthesize(req, event, dview, ids=ids,
                                 validate=validate)
        return RepairResult(alg, dview, "resynth", event, req, report)

    def _engine_for(self, dview: TopologyView,
                    event: DegradationEvent) -> SynthesisEngine:
        """The degraded fabric's engine, memoized per event. Shares the
        repairer's registry (undamaged sub-fabrics keep hitting the
        healthy fabric's phase entries) and carries the event fingerprint
        as ``degradation``, which the engine folds into whole-collective
        route keys so degraded plans never cross-serve."""
        key = event.fingerprint()
        ent = self._dengines.get(key)
        if ent is None or ent[0] is not dview.topology:
            eng = SynthesisEngine(
                dview.topology, registry=self.registry,
                gateway_strategy=self.gateway_strategy,
                sketch=self._translate_sketch(dview))
            eng.degradation = key
            ent = (dview.topology, eng)
            self._dengines[key] = ent
        return ent[1]

    def _translate_sketch(self, dview: TopologyView):
        """The repairer's sketch re-indexed into the degraded fabric: node
        ids are stable, link exclusions map through the view's compressed
        link ids (already-dead excluded links simply drop out)."""
        sk = self.sketch
        if sk is None:
            return None
        dlink = {orig: d for d, orig in enumerate(dview.links)}
        return replace(
            sk,
            exclude_links=frozenset(
                dlink[l] for l in sk.exclude_links if l in dlink),
        )

    def _resynthesize(self, req: CollectiveRequest, event: DegradationEvent,
                      dview: TopologyView, *, ids=None,
                      validate: str | None = "auto"):
        """Strategy 2: cold synthesis of the request on the surviving
        fabric through the shared registry. A HierarchyError that escapes
        (the caller pinned ``hierarchy="always"`` on a fabric that can no
        longer take the pod-aware route) means the request as stated is
        unfulfillable — re-raised as FabricDegradedError; a
        SketchInfeasibleError keeps its own loud type."""
        deng = self._engine_for(dview, event)
        try:
            alg = deng.collective(req, ids=ids)
        except SketchInfeasibleError:
            raise
        except HierarchyError as e:
            raise FabricDegradedError(
                f"{req.kind} on {dview.topology.name}: {e}") from e
        if validate is not None:
            alg.validate(validate)
        return alg

    def _repair_phases(self, req: CollectiveRequest, record: PhasePlan,
                       sub_records: tuple, event: DegradationEvent,
                       dview: TopologyView, report: DamageReport, *,
                       validate: str | None = "auto") -> RepairResult | None:
        """Strategy 1: keep undamaged phases verbatim, re-synthesize
        damaged ones on their degraded sub-views, re-stitch, validate.
        Returns None whenever the damage crosses what phase-local repair
        can express — the caller falls back to resynthesis."""
        if report.gateway_loss:
            # a lost gateway re-routes every chunk's egress/ingress: the
            # kept phases' condition sets would be wrong, not just stale
            return None
        topo = self.topology
        removed = set(event.failed_links)
        for n in event.failed_npus:
            removed.update(l.id for l in topo.links
                           if l.src == n or l.dst == n)
        dead = set(event.failed_npus)
        dlink = {orig: d for d, orig in enumerate(dview.links)}
        deng = self._engine_for(dview, event)
        dhier = deng.hierarchical()
        try:
            repaired = self._repair_record(
                record, dtopo=dview.topology, deng=deng, dhier=dhier,
                lmap=dlink, dead=dead, sub_records=sub_records)
            if repaired is None:
                return None
            alg, kept, resynth = repaired
            if validate is not None:
                alg.validate(validate)
        except (HierarchyError, ValueError, KeyError, RuntimeError,
                AssertionError):
            # anything phase repair cannot express — an unreachable phase
            # condition (pathfinding asserts on a dest no longer reachable
            # within the damaged sub-view), a validation miss on the
            # stitched plan — falls back to cold degraded synthesis:
            # never a wrong plan
            return None
        return RepairResult(alg, dview, "phases", event, req, report,
                            phases_kept=kept, phases_resynthesized=resynth)

    def _repair_record(self, record: PhasePlan, *, dtopo: Topology,
                       deng: SynthesisEngine, dhier, lmap: dict,
                       dead: set, sub_records: tuple):
        """Repair one captured composition onto a degraded topology whose
        node ids coincide with the record's coordinate space (at the top
        level that space is global; in a recursive call it is the damaged
        pod's local ids, which are position-stable because degradation
        keeps node ids). ``lmap`` maps the record's link ids into
        ``dtopo``'s — a missing key is a dead link.

        A damaged phase is repaired by the cheapest route that holds:
        chunk-granular splice (:meth:`_patch_phase`), then — when the
        phase's own nested composition was captured at plan() time —
        *recursive* phase repair (only the damaged rack of the damaged pod
        re-synthesizes; the pod's other racks are kept verbatim), then
        whole-phase re-synthesis through the shared registry. Returns
        ``(algorithm, phases_kept, phases_resynthesized)`` or None when
        the record cannot express the damage."""
        new_phases = []
        kept = resynth = 0
        for ph in record.phases:
            if all(l in lmap for l in ph.link_map) \
                    and not (set(ph.node_map) & dead):
                new_phases.append(replace(
                    ph, link_map=[lmap[l] for l in ph.link_map]))
                kept += 1
                continue
            kind = ph.name.split(":", 1)[0]
            if kind == "inter":
                dsub = dhier._boundary()
            elif kind in ("intra", "scatter"):
                dsub = dtopo.pod_subtopology(int(ph.name.split(":")[1]))
            else:
                return None
            if list(dsub.nodes) != list(ph.node_map):
                # the damage changed the sub-view's node set (e.g. a
                # gateway fell off the boundary): phase-local ids no
                # longer line up — resynthesize the whole collective
                return None
            alg = self._patch_phase(ph, dsub, lmap, dead, deng)
            if alg is None:
                alg = self._repair_nested(ph, dsub, lmap, dhier,
                                          sub_records)
            if alg is None:
                # pipeline=False keeps any nested (pods-of-pods)
                # re-synthesis in the sequential regime, whose per-rack
                # phases are registry-cacheable: the damaged pod's
                # undamaged racks hit the plans cached at plan() time
                alg = dhier._synthesize_local(
                    dsub.topology, list(ph.algorithm.conditions),
                    kind=kind, cacheable=True, replicate=True,
                    pipeline=False)
            new_phases.append(replace(
                ph, algorithm=alg, topology=dsub.topology,
                node_map=list(dsub.nodes), link_map=list(dsub.links)))
            resynth += 1
        alg = deng.synthesize_plan(PhasePlan(
            new_phases, list(record.conditions), name=record.name))
        return alg, kept, resynth

    def _repair_nested(self, ph, dsub, lmap: dict, dhier, sub_records: tuple):
        """Recursive repair of one damaged pods-of-pods phase: when the
        phase's algorithm is the result of a nested composition captured
        at plan() time, re-enter :meth:`_repair_record` one level down —
        in the pod's local coordinates — so only the damaged rack's
        schedule re-synthesizes and the pod's other racks survive
        verbatim. Returns None (caller falls back to whole-phase
        re-synthesis) when no nested record matches: registry-hit pods
        share the canonical pod's algorithm object, so the match is by
        identity and stays exact across isomorphic pods."""
        nested = next((pl for res, pl in sub_records
                       if res is ph.algorithm), None)
        if nested is None:
            return None
        # the phase's link ids -> the degraded pod sub-topology's local
        # ids, composed through the parent map (a link absent from either
        # step is dead in the pod's surviving fabric)
        dsub_pos = {g: i for i, g in enumerate(dsub.links)}
        nlmap = {}
        for i, g in enumerate(ph.link_map):
            dg = lmap.get(g)
            if dg is not None and dg in dsub_pos:
                nlmap[i] = dsub_pos[dg]
        ndhier = dhier._nested_for(dsub.topology)
        repaired = self._repair_record(
            nested, dtopo=dsub.topology, deng=ndhier.engine, dhier=ndhier,
            lmap=nlmap, dead=set(), sub_records=sub_records)
        if repaired is None:
            return None
        return repaired[0]

    def _patch_phase(self, ph, dsub, dlink: dict, dead: set,
                     deng: SynthesisEngine):
        """Chunk-granular repair of one damaged phase: keep every chunk
        whose scheduled transfers avoid the dead hardware — removing load
        never invalidates the survivors' canonical timing — and re-route
        only the chunks that crossed it, searched on a TEN preloaded with
        the kept schedule (the engine's ``preload=`` hook). Orders of
        magnitude fewer searches than re-synthesizing the phase when one
        link died out of hundreds.

        Returns None when the phase is outside what the splice can
        express — reduce-flagged schedules time their combine tree
        globally, and non-:class:`Condition` rows (reductions) need their
        kind-specific synthesis — and the caller falls back to whole-phase
        re-synthesis."""
        old = ph.algorithm
        cols = old.columns
        if bool(cols.reduce.any()) or not all(
                isinstance(c, Condition) for c in old.conditions):
            return None
        # old-sub link id -> degraded-sub link id (through global ids;
        # dead links map to -1)
        dsub_pos = {g: i for i, g in enumerate(dsub.links)}
        lmap = np.full(len(ph.link_map), -1, np.int64)
        for l_old, g in enumerate(ph.link_map):
            dg = dlink.get(g)
            if dg is not None and dg in dsub_pos:
                lmap[l_old] = dsub_pos[dg]
        bad = lmap[cols.link] < 0
        dead_local = [i for i, n in enumerate(ph.node_map) if n in dead]
        if dead_local:
            dl = np.asarray(dead_local, np.int64)
            bad |= np.isin(cols.src, dl) | np.isin(cols.dst, dl)
        damaged = np.unique(cols.chunk[bad])
        n_chunks = len({c.chunk for c in old.conditions})
        if n_chunks and len(damaged) > 0.25 * n_chunks:
            # most chunks crossed the dead hardware (a multicast phase's
            # trees visit every member, so one dead link can taint nearly
            # all of them): per-chunk re-search on the congested composed
            # view costs more than nested re-synthesis, whose per-rack
            # pieces registry-hit — let the caller take that path
            return None
        keep = ~np.isin(cols.chunk, damaged)
        kept = TransferColumns(
            cols.chunk[keep], lmap[cols.link[keep]].astype(np.int32),
            cols.src[keep], cols.dst[keep], cols.start[keep],
            cols.end[keep], cols.reduce[keep])
        dmg = {int(c) for c in damaged}
        conds_d = [c for c in old.conditions if c.chunk in dmg]
        if len(conds_d) != len(dmg):
            # a damaged chunk with no condition row of its own (composed
            # provenance): the splice cannot re-derive its requirement
            return None
        if conds_d:
            pre = CollectiveAlgorithm(dsub.topology, [], kept, name="kept")
            newalg = deng.synthesize(conds_d, preload=pre,
                                     topology=dsub.topology, replicate=True,
                                     name=old.name)
            cols_out = TransferColumns.concat([kept, newalg.columns])
        else:
            cols_out = kept
        return CollectiveAlgorithm(dsub.topology, list(old.conditions),
                                   cols_out, name=old.name)
