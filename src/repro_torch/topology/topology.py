"""Physical network topology model.

A topology is a directed multigraph over *devices*. Devices are either NPUs
(compute endpoints that may source/sink collective chunks) or switches
(forwarding-only devices with optional buffer limits and multicast support,
paper §4.7). Every directed link carries its own alpha (latency, us) and
beta (1/bandwidth, us per byte) — the alpha-beta model of paper §4.6 — so
heterogeneous and asymmetric networks are first-class.

Multi-pod fabrics additionally carry *partition metadata*: a pod id per
device (``set_partition``), from which derived views are computed — per-pod
sub-topologies, the boundary link set, the boundary sub-topology the
inter-pod synthesis phase runs on, and a quotient "pod graph" whose nodes
are pods. The hierarchical synthesis pipeline (:mod:`repro.core.hierarchy`)
consumes these views; generators that know their pod structure
(``multi_pod``, ``two_level_switch``, ``grid_hypercube``, ``three_level``)
set the partition automatically, and custom fabrics can call
``set_partition`` directly.

Partitions form a *tree*, not just one level: ``set_partition`` accepts
nested specs — each entry is either a pod id or a path ``(pod, sub_pod,
...)`` naming the device's pod at every level (rack -> pod -> plane
fabrics). ``pod_subtopology`` then returns a sub-topology that itself
carries the next level's partition (the path tails), so hierarchical
synthesis recurses: each intra-pod phase re-enters the pod-aware pipeline
on the pod's own partitioned fabric, with parent-id lifting composed
across levels through the stacked :class:`TopologyView` maps.
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass

import numpy as np

try:  # scipy serves all-pairs hop distances in one C sweep when present;
    # imported at module load so the cost never lands inside a timed region
    from scipy.sparse import csr_matrix as _sp_csr_matrix
    from scipy.sparse.csgraph import shortest_path as _sp_shortest_path
except ImportError:  # pragma: no cover - scipy ships in the image
    _sp_csr_matrix = _sp_shortest_path = None


class NodeType(enum.Enum):
    NPU = "npu"
    SWITCH = "switch"


@dataclass(frozen=True)
class Node:
    """A device in the network."""

    id: int
    type: NodeType = NodeType.NPU
    # Switch-only attributes (ignored for NPUs):
    buffer_limit: int | None = None  # max chunks resident at once (None = inf)
    multicast: bool = True  # can forward one incoming chunk on >1 link per step


@dataclass(frozen=True)
class Link:
    """A directed physical link src -> dst with alpha-beta timing."""

    id: int
    src: int
    dst: int
    alpha: float = 0.0  # latency in us
    beta: float = 1.0  # us per byte (1/bandwidth)

    def transfer_time(self, chunk_bytes: float) -> float:
        """alpha + m * beta (paper Fig. 9)."""
        return self.alpha + chunk_bytes * self.beta


@dataclass(frozen=True)
class CSRAdjacency:
    """Cached array export of the out-adjacency, in ``out_links`` order.

    Edge ``e`` of node ``u`` lives at positions ``indptr[u] .. indptr[u+1]``;
    ``link_ids[e]``/``dst_ids[e]`` are the link id and head node. The numpy
    arrays drive vectorized passes (frontier masks, distance sweeps); the
    plain-list mirrors (`adj`, `is_switch`, `serial_switch`) serve the scalar
    hot loops in :mod:`repro.core.pathfinding`, where list indexing beats
    numpy scalar indexing by ~3x.
    """

    indptr: np.ndarray  # [num_nodes + 1] int32
    link_ids: np.ndarray  # [num_links] int32
    dst_ids: np.ndarray  # [num_links] int32
    src_ids: np.ndarray  # [num_links] int32 (edge -> tail node)
    # scalar mirrors for the pathfinding hot loop
    adj: tuple  # adj[u] = ((edge_idx, dst, link_id), ...)
    edge_dst: tuple  # per-edge head node
    edge_src: tuple  # per-edge tail node
    edge_link: tuple  # per-edge link id
    is_switch: tuple  # per-node bool
    serial_switch: tuple  # per-node bool: switch and not multicast
    limited_switches: tuple  # node ids of switches with a buffer_limit
    any_switch: bool
    # True iff some switch actually constrains the search (finite buffer or
    # serialized egress); unlimited multicast switches behave like NPUs, so
    # unconstrained fabrics take the fast pathfinding/commit paths
    constrained_switch: bool = False


@dataclass(frozen=True)
class TopologyView:
    """A sub-topology extracted from a parent fabric, plus the coordinate
    maps needed to lift synthesized transfers back into the parent.

    ``nodes[i]`` / ``links[j]`` are the parent ids of local node ``i`` /
    local link ``j``; local ids are dense and assigned in ascending parent-id
    order, so two structurally-identical pods of one fabric extract to
    byte-identical local topologies (and therefore equal registry
    fingerprints — the property hierarchical synthesis relies on to pay one
    synthesis for N isomorphic pods).
    """

    topology: "Topology"
    parent: "Topology"
    nodes: tuple[int, ...]  # local node id -> parent node id
    links: tuple[int, ...]  # local link id -> parent link id

    @property
    def to_local(self) -> dict[int, int]:
        got = self.__dict__.get("_to_local")
        if got is None:
            got = {g: l for l, g in enumerate(self.nodes)}
            self.__dict__["_to_local"] = got
        return got


class Topology:
    """Directed multigraph with O(1) adjacency lookups.

    Node ids must be dense integers starting at 0 (NPUs and switches share
    one id space). Link ids are assigned densely in insertion order.
    """

    def __init__(self, name: str = "topology"):
        self.name = name
        self.nodes: list[Node] = []
        self.links: list[Link] = []
        self._out: list[list[Link]] = []  # node id -> outgoing links
        self._in: list[list[Link]] = []  # node id -> incoming links
        # Known symmetry generators: node permutations that map the topology
        # onto itself (set by generators that know their structure, e.g.
        # torus translations). The algorithm registry verifies each one
        # before use, so a wrong generator degrades cache sharing, never
        # correctness. Empty = only the identity is assumed.
        self.automorphism_generators: list[tuple[int, ...]] = []
        # Partition metadata: node id -> pod id (-1 = shared/unassigned,
        # e.g. an inter-pod switch). None until set_partition is called.
        self._pod_of: tuple[int, ...] | None = None
        # Full partition-tree paths: node id -> (pod, sub_pod, ...). Kept
        # alongside the top-level view; tails seed nested sub-partitions.
        self._pod_paths: tuple[tuple[int, ...], ...] | None = None

    # -- construction ------------------------------------------------------
    def _invalidate_caches(self) -> None:
        """Drop memoized derived state (structure hash, automorphism closure,
        attached synthesis engines) when the graph mutates."""
        # the reversed-view memo is symmetric: mutating either side must
        # break BOTH backlinks, or the unchanged peer would keep serving
        # this (no longer link-reversed) object from its cache
        rev = getattr(self, "_rev_cache", None)
        if rev is not None and getattr(rev, "_rev_cache", None) is self:
            del rev._rev_cache
        for attr in ("_structure_hash", "_automorphism_closure",
                     "_pccl_engines", "_csr_cache", "_rev_dist_rows",
                     "_adjh_rows", "_bfs_scratch", "_hop_matrix_cache",
                     "_pod_views", "_rev_cache", "_partition_fp",
                     "_degraded_views"):
            if hasattr(self, attr):
                delattr(self, attr)

    def add_node(
        self,
        type: NodeType = NodeType.NPU,
        buffer_limit: int | None = None,
        multicast: bool = True,
    ) -> int:
        self._invalidate_caches()
        nid = len(self.nodes)
        self.nodes.append(Node(nid, type, buffer_limit, multicast))
        self._out.append([])
        self._in.append([])
        if self._pod_of is not None:  # nodes added later start unassigned
            self._pod_of = self._pod_of + (-1,)
            self._pod_paths = self._pod_paths + ((-1,),)
        return nid

    def add_npus(self, n: int) -> list[int]:
        return [self.add_node(NodeType.NPU) for _ in range(n)]

    def add_link(
        self, src: int, dst: int, alpha: float = 0.0, beta: float = 1.0
    ) -> int:
        if src == dst:
            raise ValueError(f"self-link on node {src}")
        self._invalidate_caches()
        link = Link(len(self.links), src, dst, alpha, beta)
        self.links.append(link)
        self._out[src].append(link)
        self._in[dst].append(link)
        return link.id

    def add_bidir_link(
        self, a: int, b: int, alpha: float = 0.0, beta: float = 1.0
    ) -> tuple[int, int]:
        return self.add_link(a, b, alpha, beta), self.add_link(b, a, alpha, beta)

    # -- queries -----------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_links(self) -> int:
        return len(self.links)

    @property
    def npus(self) -> list[int]:
        return [n.id for n in self.nodes if n.type is NodeType.NPU]

    @property
    def switches(self) -> list[int]:
        return [n.id for n in self.nodes if n.type is NodeType.SWITCH]

    def out_links(self, node: int) -> list[Link]:
        return self._out[node]

    def in_links(self, node: int) -> list[Link]:
        return self._in[node]

    def is_switch(self, node: int) -> bool:
        return self.nodes[node].type is NodeType.SWITCH

    def homogeneous(self) -> bool:
        """True iff every link has identical (alpha, beta)."""
        if not self.links:
            return True
        a0, b0 = self.links[0].alpha, self.links[0].beta
        return all(l.alpha == a0 and l.beta == b0 for l in self.links)

    # -- partition metadata (multi-pod fabrics) ----------------------------
    @staticmethod
    def _validate_paths(paths: list[tuple[int, ...]], where: str) -> None:
        """Recursive partition-tree validation: at every level the pod ids in
        use are dense ``0..P-1`` (``-1`` = shared, and terminates its path),
        and each pod's tails form a valid partition of the next level."""
        heads = [p[0] for p in paths]
        if any(h < -1 for h in heads):
            raise ValueError(f"pod ids must be >= -1 ({where})")
        used = sorted({h for h in heads if h >= 0})
        if used != list(range(len(used))):
            raise ValueError(
                f"pod ids must be dense 0..P-1, got {used} ({where})")
        for p in paths:
            if p[0] == -1 and len(p) > 1:
                raise ValueError(
                    f"shared (-1) must terminate its partition path, got "
                    f"{p} ({where})")
        for pod in used:
            tails = [p[1:] for p in paths if p[0] == pod and len(p) > 1]
            if tails:
                Topology._validate_paths(tails, f"{where}/pod{pod}")

    def set_partition(self, pod_of) -> None:
        """Declare pod membership: ``pod_of[node]`` is either a pod id with
        pods dense ``0..P-1`` (``-1`` marks shared devices owned by no pod,
        e.g. an inter-pod DCI switch), or a nested *path* ``(pod, sub_pod,
        ...)`` assigning the device at every level of a partition tree
        (``(p, -1)`` = in pod ``p`` but shared at the next level). Generators
        with known structure call this; custom fabrics may too. Derived views
        (:meth:`pod_subtopology`, :meth:`boundary_subtopology`,
        :meth:`pod_graph`) are recomputed lazily after every call;
        ``pod_subtopology`` of a pod with a sub-partition returns a topology
        carrying that sub-partition, which is how hierarchical synthesis
        recurses through rack -> pod -> plane fabrics."""
        paths = []
        for p in pod_of:
            if isinstance(p, (int, np.integer)):
                paths.append((int(p),))
            else:
                path = tuple(int(x) for x in p)
                if not path:
                    raise ValueError("empty partition path")
                paths.append(path)
        if len(paths) != self.num_nodes:
            raise ValueError(
                f"partition names {len(paths)} nodes, fabric has "
                f"{self.num_nodes}"
            )
        self._validate_paths(paths, self.name)
        self._pod_paths = tuple(paths)
        self._pod_of = tuple(p[0] for p in paths)
        for attr in ("_pod_views", "_partition_fp"):
            if hasattr(self, attr):
                delattr(self, attr)

    @property
    def partition(self) -> tuple[int, ...] | None:
        """Top-level ``pod_of`` tuple, or None for unpartitioned fabrics."""
        return self._pod_of

    @property
    def partition_paths(self) -> tuple[tuple[int, ...], ...] | None:
        """Full per-node partition-tree paths (None = unpartitioned)."""
        return self._pod_paths

    @property
    def partition_depth(self) -> int:
        """Number of partition levels: 0 = unpartitioned, 1 = flat pods,
        2 = pods-of-pods (three routing levels), counting only assigned
        (``>= 0``) path entries."""
        if self._pod_paths is None:
            return 0
        return max(
            (sum(1 for x in p if x >= 0) for p in self._pod_paths),
            default=0,
        )

    def partition_fingerprint(self) -> str | None:
        """Stable hash of the full partition tree (None = unpartitioned).

        Registry keys for hierarchical routes must include this: the
        topology *structure* hash is partition-blind, so a 2-level and a
        3-level view of the same fabric would otherwise collide and a
        cached 2-level plan could be served for the 3-level view."""
        if self._pod_paths is None:
            return None
        got = getattr(self, "_partition_fp", None)
        if got is None:
            got = hashlib.sha256(
                repr(self._pod_paths).encode()).hexdigest()[:16]
            self._partition_fp = got
        return got

    @property
    def num_pods(self) -> int:
        if self._pod_of is None:
            return 0
        return max(self._pod_of) + 1 if self._pod_of else 0

    def pod_of(self, node: int) -> int:
        if self._pod_of is None:
            raise ValueError(f"{self.name}: no partition set")
        return self._pod_of[node]

    def _views(self) -> dict:
        views = getattr(self, "_pod_views", None)
        if views is None:
            views = self._pod_views = {}
        return views

    def pods(self) -> list[list[int]]:
        """Node ids per pod (ascending), excluding unassigned devices."""
        views = self._views()
        got = views.get("pods")
        if got is None:
            if self._pod_of is None:
                raise ValueError(f"{self.name}: no partition set")
            got = [[] for _ in range(self.num_pods)]
            for node, p in enumerate(self._pod_of):
                if p >= 0:
                    got[p].append(node)
            views["pods"] = got
        return got

    def pod_npus(self, pod: int) -> list[int]:
        return [n for n in self.pods()[pod]
                if self.nodes[n].type is NodeType.NPU]

    def boundary_links(self) -> list[Link]:
        """Links whose endpoints lie in different pods (a ``-1`` endpoint
        counts as its own side): the inter-pod fabric."""
        views = self._views()
        got = views.get("boundary")
        if got is None:
            pod = self.pod_of
            got = [l for l in self.links if pod(l.src) != pod(l.dst)]
            views["boundary"] = got
        return got

    def _extract(self, node_ids, link_ids, name: str) -> TopologyView:
        """Build a :class:`TopologyView` over the given parent node/link ids
        (ascending parent order -> dense local ids)."""
        node_ids = sorted(node_ids)
        link_ids = sorted(link_ids)
        sub = Topology(name)
        local = {}
        for g in node_ids:
            nd = self.nodes[g]
            local[g] = sub.add_node(nd.type, nd.buffer_limit, nd.multicast)
        for g in link_ids:
            l = self.links[g]
            sub.add_link(local[l.src], local[l.dst], l.alpha, l.beta)
        return TopologyView(sub, self, tuple(node_ids), tuple(link_ids))

    def pod_subtopology(self, pod: int) -> TopologyView:
        """Pod ``pod``'s internal fabric: its nodes plus the links with both
        endpoints inside it. Isomorphic pods extract to identical local
        topologies (same registry fingerprint), which is what lets one
        synthesized pod plan serve every pod.

        On a nested partition tree the extracted topology carries the next
        level's partition (the members' path tails), so hierarchical
        synthesis re-enters the pod-aware pipeline on it — the recursion
        step of rack -> pod -> plane decomposition. Two isomorphic pods with
        equal sub-partitions extract to identical sub-topologies *and*
        identical partition fingerprints, preserving registry sharing at
        every level."""
        views = self._views()
        got = views.get(("sub", pod))
        if got is None:
            members = set(self.pods()[pod])
            links = [l.id for l in self.links
                     if l.src in members and l.dst in members]
            got = self._extract(members, links,
                                f"{self.name}_pod{pod}")
            if self._pod_paths is not None:
                tails = [self._pod_paths[g][1:] or (-1,)
                         for g in got.nodes]
                if any(t[0] >= 0 for t in tails):
                    got.topology.set_partition(tails)
            views[("sub", pod)] = got
        return got

    def gateways(self, pod: int) -> list[int]:
        """Pod ``pod``'s gateway NPUs: NPU endpoints of boundary links when
        any exist, else the pod NPUs one hop inside its boundary switches
        (two-level-switch style fabrics, where the boundary port is the
        local switch itself)."""
        views = self._views()
        got = views.get(("gw", pod))
        if got is not None:
            return got
        members = set(self.pods()[pod])
        ports = sorted(
            {e for l in self.boundary_links()
             for e in (l.src, l.dst) if e in members}
        )
        npu_ports = [n for n in ports
                     if self.nodes[n].type is NodeType.NPU]
        if npu_ports:
            got = npu_ports
        else:
            got = sorted({
                l.src
                for sw in ports
                for l in self._in[sw]
                if l.src in members
                and self.nodes[l.src].type is NodeType.NPU
            })
        views[("gw", pod)] = got
        return got

    def boundary_subtopology(self) -> TopologyView:
        """The fabric the inter-pod synthesis phase runs on: every boundary
        link, the unassigned (shared) devices with their internal links, each
        pod's boundary ports — and, for pods whose ports are switches, the
        gateway NPUs plus their links to those switches, so inter-pod
        conditions can still originate and terminate at NPUs."""
        views = self._views()
        got = views.get("bsub")
        if got is not None:
            return got
        pod = self.pod_of
        nodes: set[int] = set()
        links: set[int] = set()
        for l in self.boundary_links():
            links.add(l.id)
            nodes.update((l.src, l.dst))
        # shared devices and the links among them
        shared = {n.id for n in self.nodes if pod(n.id) == -1}
        nodes.update(shared)
        links.update(l.id for l in self.links
                     if l.src in shared and l.dst in shared)
        # switch-port pods: pull in gateway NPUs + their port links
        for p in range(self.num_pods):
            gws = set(self.gateways(p))
            if gws & nodes:
                continue  # NPU ports already present
            nodes.update(gws)
            links.update(
                l.id for l in self.links
                if (l.src in gws and l.dst in nodes and pod(l.dst) == p)
                or (l.dst in gws and l.src in nodes and pod(l.src) == p)
            )
        got = self._extract(nodes, links, f"{self.name}_boundary")
        views["bsub"] = got
        return got

    def pod_graph(self) -> "Topology":
        """Quotient "pod graph": one NPU-node per pod, one node per shared
        device (keeping its type/attrs), and one link per boundary link with
        its timing carried over — the coarse view used to reason about
        pod-level routes and reachability."""
        views = self._views()
        got = views.get("graph")
        if got is not None:
            return got
        g = Topology(f"{self.name}_podgraph")
        for _ in range(self.num_pods):
            g.add_node(NodeType.NPU)
        shared_map = {}
        for n in self.nodes:
            if self.pod_of(n.id) == -1:
                shared_map[n.id] = g.add_node(
                    n.type, n.buffer_limit, n.multicast)

        def q(node: int) -> int:
            p = self.pod_of(node)
            return shared_map[node] if p == -1 else p

        for l in self.boundary_links():
            g.add_link(q(l.src), q(l.dst), l.alpha, l.beta)
        for l in self.links:
            if self.pod_of(l.src) == -1 and self.pod_of(l.dst) == -1:
                g.add_link(q(l.src), q(l.dst), l.alpha, l.beta)
        views["graph"] = g
        return g

    # -- array adjacency ---------------------------------------------------
    def csr(self) -> CSRAdjacency:
        """The cached :class:`CSRAdjacency` export (rebuilt on mutation)."""
        cached = getattr(self, "_csr_cache", None)
        if cached is not None:
            return cached
        n = self.num_nodes
        indptr = np.zeros(n + 1, dtype=np.int32)
        link_ids = np.empty(self.num_links, dtype=np.int32)
        dst_ids = np.empty(self.num_links, dtype=np.int32)
        src_ids = np.empty(self.num_links, dtype=np.int32)
        adj = []
        e = 0
        for u in range(n):
            rows = []
            for link in self._out[u]:
                link_ids[e] = link.id
                dst_ids[e] = link.dst
                src_ids[e] = u
                rows.append((e, link.dst, link.id))
                e += 1
            indptr[u + 1] = e
            adj.append(tuple(rows))
        is_switch = tuple(nd.type is NodeType.SWITCH for nd in self.nodes)
        serial = tuple(
            is_switch[nd.id] and not nd.multicast for nd in self.nodes
        )
        limited = tuple(
            nd.id for nd in self.nodes
            if is_switch[nd.id] and nd.buffer_limit is not None
        )
        cached = CSRAdjacency(
            indptr, link_ids, dst_ids, src_ids, tuple(adj),
            tuple(int(x) for x in dst_ids),
            tuple(int(x) for x in src_ids),
            tuple(int(x) for x in link_ids),
            is_switch, serial, limited, any(is_switch),
            bool(limited) or any(serial),
        )
        self._csr_cache = cached
        return cached

    # -- distances ---------------------------------------------------------
    def hop_distances_from(self, src: int) -> list[int]:
        """Unweighted BFS hop distance from src to all nodes (-1 = unreachable)."""
        return self.hop_distances_np(src).tolist()

    def hop_distances_np(self, src: int) -> np.ndarray:
        """Vectorized hop distances from ``src`` (int32, -1 = unreachable):
        one numpy frontier sweep per BFS level over the CSR arrays."""
        csr = self.csr()
        dist = np.full(self.num_nodes, -1, dtype=np.int32)
        dist[src] = 0
        frontier = np.array([src], dtype=np.int32)
        d = 0
        indptr, dst_ids = csr.indptr, csr.dst_ids
        while frontier.size:
            starts = indptr[frontier]
            counts = indptr[frontier + 1] - starts
            total = int(counts.sum())
            if not total:
                break
            owner = np.repeat(np.arange(frontier.size), counts)
            offsets = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            nbrs = dst_ids[starts[owner] + offsets]
            nbrs = np.unique(nbrs[dist[nbrs] < 0])
            d += 1
            dist[nbrs] = d
            frontier = nbrs.astype(np.int32)
        return dist

    def hop_matrix(self):
        """All-pairs hop-distance matrix ``D[i, j] = hops i -> j`` (float,
        inf = unreachable), computed in one scipy C sweep and cached — the
        single source for both from-source rows (condition ordering) and
        to-destination columns (the pathfinding heuristic). Returns ``None``
        when scipy is unavailable or the graph has no links."""
        cached = getattr(self, "_hop_matrix_cache", None)
        if cached is None:
            if _sp_shortest_path is not None and self.num_links:
                csr = self.csr()
                n = self.num_nodes
                graph = _sp_csr_matrix(
                    (np.ones(len(csr.dst_ids)),
                     (csr.src_ids, csr.dst_ids)),
                    shape=(n, n),
                )
                cached = (_sp_shortest_path(graph, method="D",
                                            unweighted=True),)
            else:
                cached = (False,)
            self._hop_matrix_cache = cached
        matrix = cached[0]
        return None if matrix is False else matrix

    def hop_distances_to(self, dst: int) -> list[int]:
        """Hop distance from every node to ``dst`` over directed links
        (reverse BFS), cached per destination — the admissible heuristic
        used by the pathfinding search bound. Served from the shared
        all-pairs matrix when available."""
        rows = getattr(self, "_rev_dist_rows", None)
        if rows is None:
            rows = self._rev_dist_rows = {}
        got = rows.get(dst)
        if got is not None:
            return got
        matrix = self.hop_matrix()
        if matrix is not None:
            col = matrix[:, dst]
            dist = [-1 if x == float("inf") else int(x) for x in col]
            rows[dst] = dist
            return dist
        dist = [-1] * self.num_nodes
        dist[dst] = 0
        frontier = [dst]
        while frontier:
            nxt = []
            for x in frontier:
                dx1 = dist[x] + 1
                for link in self._in[x]:
                    if dist[link.src] < 0:
                        dist[link.src] = dx1
                        nxt.append(link.src)
            frontier = nxt
        rows[dst] = dist
        return dist

    def degraded(self, failed_links=(), failed_npus=()) -> TopologyView:
        """The surviving fabric after losing ``failed_links`` (link ids)
        and/or ``failed_npus`` (node ids): a :class:`TopologyView` whose
        topology keeps *every* node — dead devices stay as isolated nodes,
        so node ids are stable across degradation (``view.nodes`` is the
        identity) — and drops the failed links plus every link incident to
        a failed node (``view.links`` maps surviving local link ids back to
        this fabric's).

        The view's topology carries the full partition tree and the
        declared automorphism generators: an *undamaged* pod of the
        degraded fabric extracts to a sub-topology byte-identical to the
        original pod's (same nodes, surviving links in the same relative
        order), so registry entries synthesized on the healthy fabric keep
        serving the undamaged pods of the degraded one — the property
        incremental plan repair (:mod:`repro.core.repair`) relies on.
        Generators broken by the damage are filtered out by the registry's
        per-use verification, degrading sharing, never correctness.

        Memoized per (failed links, failed npus) set pair; mutation of the
        fabric drops the memo."""
        fl = frozenset(int(l) for l in failed_links)
        fn = frozenset(int(n) for n in failed_npus)
        for l in fl:
            if not 0 <= l < self.num_links:
                raise ValueError(f"unknown link id {l}")
        for n in fn:
            if not 0 <= n < self.num_nodes:
                raise ValueError(f"unknown node id {n}")
        views = getattr(self, "_degraded_views", None)
        if views is None:
            views = self._degraded_views = {}
        got = views.get((fl, fn))
        if got is not None:
            return got
        keep = [l.id for l in self.links
                if l.id not in fl and l.src not in fn and l.dst not in fn]
        got = self._extract(range(self.num_nodes), keep,
                            f"{self.name}_degraded")
        sub = got.topology
        sub.automorphism_generators = list(self.automorphism_generators)
        if self._pod_paths is not None:
            sub.set_partition(list(self._pod_paths))
        views[(fl, fn)] = got
        return got

    def reversed(self) -> "Topology":
        """The link-reversed view (used for reduction synthesis), memoized.

        Link ``k`` of the reversed topology is link ``k`` of this one with its
        endpoints swapped, so link ids carry over between the two orientations
        — the property the time-reversal trick relies on to lift reduction
        schedules back onto the forward fabric. The view is cached and carries
        a backlink, so ``reversed()`` of the reversed view round-trips to this
        very object (pod sub-/boundary views derived on either orientation
        therefore extract the same parent node/link id sets). Mutating the
        fabric drops the cache and a fresh view is built.

        Derived caches are carried instead of recomputed: the reversed view's
        all-pairs hop matrix is the transpose of the forward one (link
        reversal flips every path), so an already-computed forward matrix is
        shared by value. The CSR export and per-destination rows stay lazy —
        they are direction-dependent and rebuild on first use against the
        reversed adjacency, so no stale forward adjacency can leak. Partition
        metadata (pod membership, and therefore gateways) is
        direction-agnostic and carries over."""
        cached_rev = getattr(self, "_rev_cache", None)
        if cached_rev is not None:
            return cached_rev
        rev = Topology(self.name + "_rev")
        for node in self.nodes:
            rev.add_node(node.type, node.buffer_limit, node.multicast)
        for link in self.links:
            rev.add_link(link.dst, link.src, link.alpha, link.beta)
        # node symmetries are direction-agnostic, as is pod membership
        # (the full partition-tree paths carry over, so nested reversed
        # pod views decompose identically)
        rev.automorphism_generators = list(self.automorphism_generators)
        if self._pod_of is not None:
            rev._pod_of = self._pod_of
            rev._pod_paths = self._pod_paths
        cached = getattr(self, "_hop_matrix_cache", None)
        if cached is not None and cached[0] is not False:
            rev._hop_matrix_cache = (cached[0].T,)
        self._rev_cache = rev
        rev._rev_cache = self
        return rev

    def __repr__(self) -> str:
        return (
            f"Topology({self.name!r}, nodes={self.num_nodes} "
            f"(npus={len(self.npus)}, switches={len(self.switches)}), "
            f"links={self.num_links})"
        )
