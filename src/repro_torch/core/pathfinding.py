"""BFS pathfinding over the TEN (paper §4.3, Algorithm 2) — batched frontier.

Given one condition (chunk, src, dests), find timed store-and-forward paths
from src to every destination, over links not yet occupied by previously
scheduled chunks. Three entry points:

* ``bfs_int``: the homogeneous synchronous TEN search, reformulated as a
  batched event frontier over the topology's CSR arrays and the TEN's
  occupancy bitmap. Because link occupancy is frozen for the duration of one
  search (paths commit only after the BFS returns), every edge's next free
  send slot is computable exactly, once, from the per-link occupancy masks —
  so instead of re-scanning the whole frontier at every timestep (most of
  which commit nothing), the search processes one monotone heap of edge
  events keyed ``(timestep, parent visit order, edge index)``. That key
  reproduces the reference implementation's frontier scan order exactly, so
  claims — and therefore transfers, arrivals, and makespans — are
  bit-identical to ``bfs_int_ref`` (enforced by the differential test
  suite). On switch-free topologies the search additionally prunes events
  that provably cannot influence any retained path: a greedy
  store-and-forward probe yields an upper bound on every destination's
  arrival, and an admissible hop-distance heuristic discards events beyond
  it (the bound argument is spelled out above ``_probe``).
* ``bfs_int_ref``: the original per-timestep frontier scan, kept verbatim as
  the reference for differential testing.
* ``bfs_cont``: the heterogeneous generalization (paper §4.6) — earliest-
  arrival search where each link candidate carries its alpha-beta transfer
  time and links have busy *intervals*; with all-equal link times it visits
  nodes in the same order as ``bfs_int``.

All return the *pruned* transfer set: the BFS may visit more nodes than
requested (paper Fig. 6d), and only edges on some src->dest path are retained
(Fig. 6e) — including through out-of-process-group NPUs, which is where the
paper's process-group awareness comes from.

Switch handling (paper §4.7): visiting a full switch is skipped until its
buffer drains; non-multicast switches serialize their egress (one next
neighbor per step, "visits next nodes one by one"). Switched topologies take
the general event loop — serialized egress consumes a per-step budget, so
the search-bound and push-elision optimizations (which assume an edge's fire
time is competition-independent) stay off.
"""

from __future__ import annotations

# >>> copy fix: imports of the two fixes below
import functools
import heapq
import threading
# <<< copy fix
import operator
from dataclasses import dataclass

from repro_torch.core.algorithm import Transfer
from repro_torch.core.conditions import Condition
from repro_torch.core.ten import TEN

_EPS = 1e-9

# destinations-per-condition cap for the search bound: beyond this many
# probes the heuristic costs more than the flood it avoids
_MAX_BOUND_DESTS = 4


@dataclass(slots=True)
class PathResult:
    """Pruned transfers + chunk arrival time at every retained node."""

    transfers: list[Transfer]
    arrivals: dict[int, float]  # node -> arrival time (retained nodes only)
    reached: dict[int, float]  # dest -> arrival time


def _prune(
    chunk: int,
    src: int,
    dests: frozenset[int],
    pred: dict[int, tuple[int, int, float, float]],
    visited: dict[int, float],
) -> PathResult:
    """Keep only edges on some src->dest path (paper Fig. 6e)."""
    keep: dict[tuple[int, float], Transfer] = {}
    arrivals: dict[int, float] = {src: visited[src]}
    reached: dict[int, float] = {}
    for dest in dests:
        if dest == src:
            reached[dest] = visited[src]
            continue
        if dest not in visited:
            raise AssertionError(f"chunk {chunk}: BFS did not reach dest {dest}")
        reached[dest] = visited[dest]
        node = dest
        while node != src:
            u, link, s, e = pred[node]
            key = (link, s)
            if key not in keep:
                keep[key] = Transfer(chunk, link, u, node, s, e)
            arrivals[node] = e
            node = u
    transfers = sorted(keep.values(), key=lambda t: (t.start, t.link))
    # >>> copy fix: a chunk's whole stay in a limited switch buffer
    return PathResult(transfers, arrivals, reached)


def _first_clash(ten: TEN, result: PathResult, limited) -> tuple | None:
    """(switch, instant, length of the stay) of the first retained stay
    that meets a full buffer, or None. A chunk stays in a switch from its
    arrival to its last retained forward (validate()'s residency); a switch
    the chunk only reaches, or starts from, holds no stay of this search."""
    arrive: dict[int, float] = {}
    depart: dict[int, float] = {}
    for t in result.transfers:
        if t.dst in limited:
            arrive[t.dst] = t.end
        if t.src in limited:
            depart[t.src] = max(depart.get(t.src, t.end), t.end)
    for v, a in sorted(arrive.items(), key=lambda kv: (kv[1], kv[0])):
        d = depart.get(v, a)
        if d > a:
            t = ten.stay_clash(v, a, d)
            if t is not None:
                return v, t, d - a
    return None


def _whole_stays(search):
    """Make ``search`` keep a limited switch's buffer over each chunk's whole
    stay, not only at its arrival. Where a retained stay meets a full
    buffer, the switch's arrival floor rises to the next instant with room
    after the clash (``TEN.next_room``: the exact retry of
    ``next_drop_after``), on to the first such instant from which a stay
    as long as this one meets no full buffer, and the search runs again.
    A floor only rises, and only to a committed residency's end, so the
    loop ends: at the latest once the floor passes the switch's last
    residency. On a fabric without a limited switch the search runs once,
    as before."""
    @functools.wraps(search)
    def fitted(ten: TEN, cond: Condition, *args) -> PathResult:
        result = search(ten, cond, *args)
        limited = ten.topology.csr().limited_switches
        if not limited or not result.transfers:
            return result
        limited = frozenset(limited)
        floors = ten._floors
        try:
            while True:
                clash = _first_clash(ten, result, limited)
                if clash is None:
                    return result
                v, t, length = clash
                t = ten.next_room(v, t)
                while t != float("inf") and (
                        c := ten.stay_clash(v, t, t + length)) is not None:
                    t = ten.next_room(v, c)
                floors[v] = t
                result = search(ten, cond, *args)
        finally:
            floors.clear()
    return fitted
    # <<< copy fix


# ---------------------------------------------------------------------------
# Per-topology scratch for the event search (epoch-stamped, so no per-call
# clearing): visit times/preds plus the best-pushed-slot elision table.
# ---------------------------------------------------------------------------

class _Scratch:
    """Per-topology search scratch, epoch-stamped so a new search costs one
    counter bump instead of O(n) clears. All cells hold machine-word ints
    (epoch stamps live in their own tables: mixing them into value cells
    would push every store/compare into multi-digit bigint arithmetic).
    ``pred_e`` needs no stamp of its own — it is written iff ``vis_e`` is."""

    __slots__ = ("epoch", "vis_t", "vis_e", "pred_e", "best", "best_e")

    def __init__(self, n: int):
        self.epoch = 0
        self.vis_t = [0] * n  # claim timestep (arrival)
        self.vis_e = [0] * n  # epoch stamp for vis_t/pred_e
        self.pred_e = [0] * n  # predecessor edge index
        self.best = [0] * n  # smallest pushed event key per node
        self.best_e = [0] * n  # epoch stamp for best


# >>> copy fix: path-finding scratch per thread
def _scratch_for(topo) -> _Scratch:
    """This thread's scratch for ``topo``. Two threads searching one
    topology must not share visit stamps: one thread's epoch bump makes the
    other's pruning walk predecessors that are not its own. The table stays
    under ``_bfs_scratch``, which ``Topology._invalidate_caches`` drops."""
    per_thread = topo.__dict__.setdefault("_bfs_scratch", {})
    tid = threading.get_ident()
    sc = per_thread.get(tid)
    if sc is None or len(sc.vis_t) != topo.num_nodes:
        sc = per_thread[tid] = _Scratch(topo.num_nodes)
    return sc
# <<< copy fix


def _probe(adjh, hrow, masks, mask_bl, src: int, t0: int) -> int:
    """Store-and-forward arrival bound: walk greedy shortest paths to the
    destination (descending hop distance, earliest-free link at every hop),
    one walk per distinct first hop, keeping the best arrival.
    ``adjh``/``hrow`` are the per-destination folded adjacency and hop row
    from ``_adjh_for``. Returns -1 when the destination is unreachable from
    ``src``.

    The returned time T_ub is a valid upper bound on the BFS arrival at the
    destination, and — because on switch-free topologies an edge's fire time
    does not depend on claim competition — every node on a retained path,
    every claim competitor of such a node, and (inductively) all their
    ancestors v satisfy ``claim(v) + hop(v, dest) <= T_ub``. Events outside
    that set can be dropped without changing the pruned output.
    """
    h0 = hrow[src]
    if h0 < 0:
        return -1
    best = -1
    for _, w0, lk0, hw0 in adjh[src]:
        if hw0 != h0 - 1:
            continue
        if mask_bl[lk0] <= t0:
            t = t0 + 1
        else:
            m = masks[lk0] >> t0
            t = t0 + (~m & (m + 1)).bit_length()
        v = w0
        h = h0 - 1
        while h > 0:
            # among hop-descending neighbors, follow the earliest-free link
            bt = -1
            bw = -1
            for _, w, lk, hw in adjh[v]:
                if hw == h - 1:
                    if mask_bl[lk] <= t:
                        bt, bw = t, w
                        break  # can't do better than sending now
                    m = masks[lk] >> t
                    nf = t + (~m & (m + 1)).bit_length() - 1
                    if bt < 0 or nf < bt:
                        bt, bw = nf, w
            if bw < 0:  # pragma: no cover - descent exists while h > 0
                return -1
            t = bt + 1
            v = bw
            h -= 1
            if best >= 0 and t >= best:
                break  # already no better than a previous walk
        else:
            if best < 0 or t < best:
                best = t
    return best


def _adjh_for(topo, csr, dest: int):
    """Per-destination hop row + adjacency rows with the heuristic folded
    in: ``rows[v] = ((edge_idx, dst, link_id, hop(dst, dest)), ...)``, edges
    whose head cannot reach ``dest`` dropped. Cached per
    topology+destination — in an All-to-All every destination's rows are
    reused by every source."""
    cache = getattr(topo, "_adjh_rows", None)
    if cache is None:
        cache = topo._adjh_rows = {}
    got = cache.get(dest)
    if got is None:
        hrow = topo.hop_distances_to(dest)
        got = (hrow, tuple(
            tuple((i, w, lk, hrow[w]) for i, w, lk in row if hrow[w] >= 0)
            for row in csr.adj
        ))
        cache[dest] = got
    return got


def bfs_int(ten: TEN, cond: Condition, max_steps: int | None = None) -> PathResult:
    topo = ten.topology
    src = cond.src
    dests = cond.remote_dests
    if not dests:
        return PathResult([], {src: cond.release}, {src: cond.release})
    csr = topo.csr()
    n = topo.num_nodes
    t0 = int(cond.release)
    if max_steps is None:
        # Links become free after the committed horizon, so any connected
        # destination is reachable within horizon + |V| steps.
        max_steps = int(ten.horizon()) + n + t0 + 4
    if csr.constrained_switch:
        # Only finite buffers / serialized egress invalidate the bound and
        # elision optimizations; unlimited multicast switches (DCI/spine
        # fabrics) behave exactly like NPUs in the search, so they stay on
        # the fast path below — the switched loop's special branches would
        # never fire for them (see the no-op guards in _bfs_int_switched).
        return _bfs_int_switched(ten, cond, csr, t0, max_steps)

    masks = ten._masks
    mask_bl = ten._mask_bl
    adj = csr.adj
    edge_dst = csr.edge_dst
    E = len(edge_dst)
    # shift-packed event key: (timestep << tb) | (visit order << eb) | edge
    eb = max(1, (E - 1).bit_length())
    emask = (1 << eb) - 1
    tb = eb + n.bit_length()

    sc = _scratch_for(topo)
    ep = sc.epoch = sc.epoch + 1
    vis_t, vis_e = sc.vis_t, sc.vis_e
    pred_e = sc.pred_e
    best, best_e = sc.best, sc.best_e

    vis_e[src] = ep
    vis_t[src] = t0
    heap: list[int] = []
    push = heapq.heappush
    pop = heapq.heappop
    nseq = 1

    if len(dests) == 1:
        # hot path: single destination, bound from the greedy probe, per-
        # destination adjacency rows with the heuristic folded in
        (the_dest,) = dests
        hrow, adjh = _adjh_for(topo, csr, the_dest)
        t_ub = _probe(adjh, hrow, masks, mask_bl, src, t0)
        if t_ub >= 0:
            for i, w, lk, hw in adjh[src]:
                if w == src:
                    continue
                if mask_bl[lk] <= t0:
                    nf = t0
                else:
                    m = masks[lk] >> t0
                    nf = t0 + (~m & (m + 1)).bit_length() - 1
                if nf + hw + 1 > t_ub:
                    continue
                key = (nf << tb) | i
                best_e[w] = ep
                best[w] = key
                push(heap, key)
            while True:
                if not heap:
                    raise AssertionError(
                        f"chunk {cond.chunk}: unreachable dests {[the_dest]}"
                    )
                key = pop(heap)
                v = edge_dst[key & emask]
                if vis_e[v] == ep:
                    continue
                t = key >> tb
                if t > max_steps:
                    raise AssertionError(
                        f"chunk {cond.chunk}: unreachable dests {[the_dest]}"
                    )
                t1 = t + 1
                vis_e[v] = ep
                vis_t[v] = t1
                pred_e[v] = key & emask
                if v == the_dest:
                    break
                seq_i = nseq << eb
                nseq += 1
                for i, w, lk, hw in adjh[v]:
                    if vis_e[w] == ep:
                        continue
                    if t1 + hw + 1 > t_ub:
                        continue  # cheap reject: nf >= t1 already overshoots
                    if mask_bl[lk] <= t1:
                        nf = t1
                    else:
                        m = masks[lk] >> t1
                        nf = t1 + (~m & (m + 1)).bit_length() - 1
                    if nf + hw + 1 > t_ub:
                        continue
                    key = (nf << tb) | seq_i | i
                    if best_e[w] == ep:
                        if key > best[w]:
                            # a smaller-keyed event to w is already pending;
                            # it pops first and (claims w | finds w visited)
                            # either way, so this event can only ever pop
                            # onto a visited node
                            continue
                    else:
                        best_e[w] = ep
                    best[w] = key
                    push(heap, key)
            return _prune_scratch(cond.chunk, src, dests, sc, ep, t0, csr)
        remaining = None  # unreachable by probe: fall through unbounded
    else:
        remaining = set(dests)

    # general switch-free path: multiple destinations (bounded when few) or
    # an unreachable-destination probe (unbounded; the search will raise)
    hmin = None
    t_ub = -1
    if remaining is not None and len(dests) <= _MAX_BOUND_DESTS:
        t_ub = 0
        rows = []
        for d in dests:
            hrow, adjh = _adjh_for(topo, csr, d)
            pb = _probe(adjh, hrow, masks, mask_bl, src, t0)
            if pb < 0:
                t_ub = -1
                break
            if pb > t_ub:
                t_ub = pb
            rows.append(hrow)
        if t_ub >= 0:
            hmin = [
                min((r[v] for r in rows if r[v] >= 0), default=-1)
                for v in range(n)
            ]

    for i, w, lk in adj[src]:
        if w == src:
            continue
        if mask_bl[lk] <= t0:
            nf = t0
        else:
            m = masks[lk] >> t0
            nf = t0 + (~m & (m + 1)).bit_length() - 1
        if t_ub >= 0:
            h = hmin[w]
            if h < 0 or nf + h + 1 > t_ub:
                continue
        key = (nf << tb) | i
        best_e[w] = ep
        best[w] = key
        push(heap, key)

    single = remaining is None
    if single:
        (the_dest,) = dests
    else:
        the_dest = -1

    while True:
        if not heap:
            left = [the_dest] if single else sorted(remaining)
            raise AssertionError(f"chunk {cond.chunk}: unreachable dests {left}")
        key = pop(heap)
        v = edge_dst[key & emask]
        if vis_e[v] == ep:
            continue
        t = key >> tb
        if t > max_steps:
            left = [the_dest] if single else sorted(remaining)
            raise AssertionError(f"chunk {cond.chunk}: unreachable dests {left}")
        t1 = t + 1
        vis_e[v] = ep
        vis_t[v] = t1
        pred_e[v] = key & emask
        if single:
            if v == the_dest:
                break
        else:
            remaining.discard(v)
            if not remaining:
                break
        seq_i = nseq << eb
        nseq += 1
        for i, w, lk in adj[v]:
            if vis_e[w] == ep:
                continue
            if t_ub >= 0:
                h = hmin[w]
                if h < 0 or t1 + h + 1 > t_ub:
                    continue
            if mask_bl[lk] <= t1:
                nf = t1
            else:
                m = masks[lk] >> t1
                nf = t1 + (~m & (m + 1)).bit_length() - 1
            if t_ub >= 0 and nf + h + 1 > t_ub:
                continue
            key = (nf << tb) | seq_i | i
            if best_e[w] == ep:
                if key > best[w]:
                    continue
            else:
                best_e[w] = ep
            best[w] = key
            push(heap, key)

    return _prune_scratch(cond.chunk, src, dests, sc, ep, t0, csr)


# >>> copy fix: whole stays in the event search
@_whole_stays
def _bfs_int_switched(
    ten: TEN, cond: Condition, csr, t0: int, max_steps: int
) -> PathResult:
# <<< copy fix
    """General event loop for topologies with switches: identical ordering,
    plus per-step serialized-egress budgets and buffer-occupancy rechecks
    (both of which force event re-pushes, so the switch-free elisions are
    invalid here)."""
    topo = ten.topology
    src = cond.src
    dests = cond.remote_dests
    masks = ten._masks
    mask_bl = ten._mask_bl
    adj = csr.adj
    edge_dst = csr.edge_dst
    edge_src = csr.edge_src
    edge_link = csr.edge_link
    is_switch = csr.is_switch
    serial = csr.serial_switch
    n = topo.num_nodes
    E = len(edge_dst)
    eb = max(1, (E - 1).bit_length())
    emask = (1 << eb) - 1
    tb = eb + n.bit_length()

    sc = _scratch_for(topo)
    ep = sc.epoch = sc.epoch + 1
    vis_t, vis_e = sc.vis_t, sc.vis_e
    pred_e = sc.pred_e

    vis_e[src] = ep
    vis_t[src] = t0
    heap: list[int] = []
    push = heapq.heappush
    pop = heapq.heappop
    sent_at: dict[int, int] = {}
    remaining = set(dests)
    nseq = 1

    for i, w, lk in adj[src]:
        if w == src:
            continue
        if mask_bl[lk] <= t0:
            nf = t0
        else:
            m = masks[lk] >> t0
            nf = t0 + (~m & (m + 1)).bit_length() - 1
        push(heap, (nf << tb) | i)

    while remaining:
        if not heap:
            raise AssertionError(
                f"chunk {cond.chunk}: unreachable dests {sorted(remaining)}"
            )
        key = pop(heap)
        e = key & emask
        v = edge_dst[e]
        if vis_e[v] == ep:
            continue
        t = key >> tb
        if t > max_steps:
            raise AssertionError(
                f"chunk {cond.chunk}: unreachable dests {sorted(remaining)}"
            )
        u = edge_src[e]
        if serial[u] and sent_at.get(u) == t:
            # serialized egress: one send per step; retry from the next one
            t1 = t + 1
            lk = edge_link[e]
            if mask_bl[lk] <= t1:
                nf = t1
            else:
                m = masks[lk] >> t1
                nf = t1 + (~m & (m + 1)).bit_length() - 1
            push(heap, (nf << tb) | (key & ~(-1 << tb)))
            continue
        if is_switch[v] and not ten.buffer_has_room(v, t + 1):
            # paper §4.7: skip a full switch until its buffer drains. No
            # residency ends before the next drop, so occupancy cannot fall
            # earlier — the retry slot is exact, not a heuristic.
            d = ten.next_drop_after(v, t + 1)
            if d == float("inf"):
                continue  # permanently full via this edge
            tt = max(t + 1, -int(-(d - 1 - _EPS) // 1))
            lk = edge_link[e]
            if mask_bl[lk] <= tt:
                nf = tt
            else:
                m = masks[lk] >> tt
                nf = tt + (~m & (m + 1)).bit_length() - 1
            push(heap, (nf << tb) | (key & ~(-1 << tb)))
            continue
        if serial[u]:
            sent_at[u] = t
        t1 = t + 1
        vis_e[v] = ep
        vis_t[v] = t1
        pred_e[v] = e
        remaining.discard(v)
        if not remaining:
            break
        seq_i = nseq << eb
        nseq += 1
        for i, w, lk in adj[v]:
            if vis_e[w] == ep:
                continue
            if mask_bl[lk] <= t1:
                nf = t1
            else:
                m = masks[lk] >> t1
                nf = t1 + (~m & (m + 1)).bit_length() - 1
            push(heap, (nf << tb) | seq_i | i)

    return _prune_scratch(cond.chunk, src, dests, sc, ep, t0, csr)


def _prune_scratch(
    chunk: int, src: int, dests: frozenset[int], sc: _Scratch, ep: int,
    t0: int, csr,
) -> PathResult:
    """`_prune` over the epoch-stamped scratch arrays (identical output)."""
    vis_t, vis_e = sc.vis_t, sc.vis_e
    pred_e = sc.pred_e
    edge_src = csr.edge_src
    edge_link = csr.edge_link
    arrivals: dict[int, float] = {src: float(t0)}
    if len(dests) == 1:
        # single destination: the retained set is one chain with strictly
        # decreasing starts — build it back-to-front, no dedup or sort needed
        (dest,) = dests
        if dest == src:
            return PathResult([], arrivals, {dest: float(t0)})
        if vis_e[dest] != ep:
            raise AssertionError(f"chunk {chunk}: BFS did not reach dest {dest}")
        reached = {dest: float(vis_t[dest])}
        transfers: list[Transfer] = []
        node = dest
        while node != src:
            end = float(vis_t[node])
            e = pred_e[node]
            u = edge_src[e]
            transfers.append(
                Transfer(chunk, edge_link[e], u, node, end - 1.0, end)
            )
            arrivals[node] = end
            node = u
        transfers.reverse()
        return PathResult(transfers, arrivals, reached)
    keep: dict[tuple[int, float], Transfer] = {}
    reached = {}
    for dest in dests:
        if dest == src:
            reached[dest] = float(t0)
            continue
        if vis_e[dest] != ep:
            raise AssertionError(f"chunk {chunk}: BFS did not reach dest {dest}")
        reached[dest] = float(vis_t[dest])
        node = dest
        while node != src:
            end = vis_t[node]
            e = pred_e[node]
            link = edge_link[e]
            key = (link, float(end - 1))
            if key not in keep:
                keep[key] = Transfer(chunk, link, edge_src[e], node,
                                     float(end - 1), float(end))
            arrivals[node] = float(end)
            node = edge_src[e]
    transfers = sorted(keep.values(), key=operator.attrgetter("start", "link"))
    return PathResult(transfers, arrivals, reached)


# ---------------------------------------------------------------------------
# Reference per-timestep frontier scan (kept for differential testing)
# ---------------------------------------------------------------------------

# >>> copy fix: whole stays in the level search
@_whole_stays
def bfs_int_ref(
    ten: TEN, cond: Condition, max_steps: int | None = None
) -> PathResult:
# <<< copy fix
    """The original Algorithm 2 loop: expand the whole frontier one timestep
    at a time, in active-list order. ``bfs_int`` must match it bit-for-bit;
    tests/test_pathfinding_diff.py enforces that on random topologies and
    TEN states."""
    topo = ten.topology
    src = cond.src
    dests = cond.remote_dests
    if not dests:
        return PathResult([], {src: cond.release}, {src: cond.release})

    t = int(cond.release)
    visited: dict[int, float] = {src: float(t)}
    pred: dict[int, tuple[int, int, float, float]] = {}
    active: list[int] = [src]
    remaining = set(dests)
    if max_steps is None:
        max_steps = int(ten.horizon()) + topo.num_nodes + int(cond.release) + 4

    while remaining:
        if t > max_steps:
            raise AssertionError(
                f"chunk {cond.chunk}: unreachable dests {sorted(remaining)}"
            )
        next_active: list[int] = []
        newly: list[int] = []
        for u in active:
            node_u = topo.nodes[u]
            is_sw = ten.topology.is_switch(u)
            budget = 1 if (is_sw and not node_u.multicast) else None
            sent = 0
            has_unvisited = False
            for link in topo.out_links(u):
                v = link.dst
                if v in visited:
                    continue
                has_unvisited = True
                if budget is not None and sent >= budget:
                    break
                if not ten.free_int(link.id, t):
                    continue
                if topo.is_switch(v) and not ten.buffer_has_room(v, t + 1):
                    continue  # paper §4.7: skip full switch at this timestep
                visited[v] = float(t + 1)
                pred[v] = (u, link.id, float(t), float(t + 1))
                newly.append(v)
                remaining.discard(v)
                sent += 1
                if not remaining:
                    break
            if not remaining:
                break
            if has_unvisited:
                next_active.append(u)  # may still expand later
        active = next_active + newly
        t += 1

    return _prune(cond.chunk, src, dests, pred, visited)


# ---------------------------------------------------------------------------
# Heterogeneous earliest-arrival search (paper §4.6)
# ---------------------------------------------------------------------------

# >>> copy fix: whole stays in the heterogeneous search
@_whole_stays
def bfs_cont(ten: TEN, cond: Condition, max_time: float | None = None) -> PathResult:
# <<< copy fix
    topo = ten.topology
    src = cond.src
    dests = cond.remote_dests
    if not dests:
        return PathResult([], {src: cond.release}, {src: cond.release})

    if max_time is None:
        slowest = max(
            (l.transfer_time(cond.bytes) for l in topo.links), default=1.0
        )
        max_time = ten.horizon() + cond.release + slowest * (topo.num_nodes + 4)

    visited: dict[int, float] = {}
    pred: dict[int, tuple[int, int, float, float]] = {}
    remaining = set(dests)
    counter = 0
    heap: list[tuple[float, int, int, int, float, float]] = []
    # entry: (arrival, counter, from_node, link_id, start, end)

    # Non-multicast switches serialize egress: iterate their out-links one at
    # a time ("visits next nodes one by one", §4.7).
    serial_state: dict[int, tuple[int, float]] = {}  # switch -> (next link idx, t_free)

    def push_candidate(u: int, link, t_ready: float) -> None:
        nonlocal counter
        dur = link.transfer_time(cond.bytes)
        start = ten.earliest_free(link.id, t_ready, dur)
        end = start + dur
        v = link.dst
        # full-buffer switches delay the send until room exists on arrival
        if topo.is_switch(v):
            guard = 0
            while not ten.buffer_has_room(v, end):
                drop = ten.next_drop_after(v, end)
                if drop == float("inf") or end > max_time:
                    return  # permanently full: candidate abandoned
                start = ten.earliest_free(link.id, max(t_ready, drop - dur), dur)
                end = start + dur
                guard += 1
                if guard > 10000:
                    raise AssertionError("switch buffer search did not converge")
        if end > max_time:
            return
        counter += 1
        heapq.heappush(heap, (end, counter, u, link.id, start, end))

    def expand(u: int, t_arrive: float) -> None:
        node_u = topo.nodes[u]
        if topo.is_switch(u) and not node_u.multicast:
            serial_state[u] = (0, t_arrive)
            push_next_serial(u)
        else:
            for link in topo.out_links(u):
                if link.dst not in visited:
                    push_candidate(u, link, t_arrive)

    def push_next_serial(u: int) -> None:
        idx, t_free = serial_state[u]
        outs = topo.out_links(u)
        while idx < len(outs):
            link = outs[idx]
            serial_state[u] = (idx + 1, t_free)
            if link.dst not in visited:
                push_candidate(u, link, t_free)
                return
            idx += 1
        serial_state[u] = (idx, t_free)

    visited[src] = cond.release
    expand(src, cond.release)

    while remaining and heap:
        end, _, u, link_id, start, t_end = heapq.heappop(heap)
        link = topo.links[link_id]
        v = link.dst
        if topo.is_switch(u) and not topo.nodes[u].multicast:
            # serialized egress: this send (whether used or not) defines when
            # the next one may be attempted only if it was actually taken;
            # if v was visited meanwhile, try the next out-link immediately.
            if v in visited:
                push_next_serial(u)
                continue
            visited[v] = t_end
            pred[v] = (u, link_id, start, t_end)
            remaining.discard(v)
            idx, _ = serial_state[u]
            serial_state[u] = (idx, t_end)  # egress busy until this send ends
            push_next_serial(u)
            expand(v, t_end)
        else:
            if v in visited:
                continue
            visited[v] = t_end
            pred[v] = (u, link_id, start, t_end)
            remaining.discard(v)
            expand(v, t_end)

    if remaining:
        raise AssertionError(
            f"chunk {cond.chunk}: unreachable dests {sorted(remaining)} "
            f"within horizon {max_time}"
        )
    return _prune(cond.chunk, src, dests, pred, visited)
