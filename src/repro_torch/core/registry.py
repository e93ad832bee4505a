"""AlgorithmRegistry: fingerprinted cache of synthesized collective algorithms.

Production pods re-synthesize the *same* collectives over and over: every
data-parallel row of a (data, model) mesh is an isomorphic process group, yet
each ``synthesize_all_gather(topo, row_i)`` call used to redo the full
TEN/BFS work. The registry makes synthesized algorithms first-class,
canonicalized, cached artifacts:

* **Fingerprint** — ``(topology structure hash, collective kind, canonical
  process group, bytes/chunking params)``.
* **Canonicalization** — the process group is relabeled through a *verified*
  topology automorphism into a normal form (the lexicographically smallest
  image over the enumerated symmetry group), so all 16 rows of a 16x16 torus
  share one cached plan. Every candidate permutation is checked against the
  link/node structure before use: a wrong symmetry generator can only reduce
  sharing, never produce an invalid algorithm.
* **Lookup** — a cache hit relabels the stored canonical algorithm back
  through the inverse automorphism (nodes, link ids, and chunk ids), which is
  O(transfers) instead of O(BFS * conditions). Relabeled algorithms have the
  same makespan and pass the full validation oracle.
* **Persistence** — in-memory LRU, plus optional on-disk binary plans
  (uncompressed ``.npz``, mmap-loaded zero-copy by ``core.serialize``) so a
  pod restart reuses plans synthesized by a previous job. Legacy ``.json``
  entries (the ``to_msccl_json`` schema) are still read and migrated to npz
  in place. Writes are atomic (tmp file + rename), so any number of
  registries — across threads *and* processes — can share one
  ``PCCL_CACHE_DIR``: readers only ever see complete entries, and a stale
  or corrupt entry is dropped and resynthesized.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, replace
from typing import Callable, Sequence

from repro_torch.core.algorithm import (CollectiveAlgorithm, TransferColumns,
                                  remap_ids)
from repro_torch.core.conditions import ChunkIds, ReduceCondition
from repro_torch.topology.topology import Topology

# bound on the enumerated symmetry group (torus2d 16x16 translations = 256;
# the cap only matters for pathological generator sets)
_MAX_AUTOMORPHISMS = 4096

# Cache-key schema version, part of every fingerprint (memory and disk).
# Bump whenever the synthesis core changes in a way that could alter emitted
# schedules, so plans cached by an older core are never served by a newer
# one. v2: array-backed TEN + batched-frontier BFS core. v3: recursive
# multi-level hierarchy — hierarchical route/phase params now carry the
# partition-tree fingerprint, and pod phases on nested-partitioned
# sub-topologies synthesize recursively. v4: inter-pod traffic engineering
# — hierarchical route and hier:* phase params now carry the resolved
# gateway strategy and the CommSketch fingerprint. v5: chunk-granular
# cross-phase pipelining — the hierarchical All-Reduce junction and the
# pipelined scatter route are per-chunk released, and uniform-release
# phases are cached canonically (release-stripped); a v4 barrier plan and
# a v5 pipelined plan for the same key are different schedules, so entries
# must never cross-serve.
SCHEMA_VERSION = 5


# ---------------------------------------------------------------------------
# Topology structure hashing and automorphism handling
# ---------------------------------------------------------------------------

def topology_fingerprint(topo: Topology) -> str:
    """Hash of the labeled topology structure (nodes, attrs, links, timing).

    Name-independent: two generator calls producing the same graph hash
    equal, so registries persist across processes that rebuild the fabric.
    """
    cached = getattr(topo, "_structure_hash", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    for n in topo.nodes:
        h.update(repr((n.type.value, n.buffer_limit, n.multicast)).encode())
    for l in topo.links:
        h.update(repr((l.src, l.dst, l.alpha, l.beta)).encode())
    digest = h.hexdigest()
    topo._structure_hash = digest
    return digest


def is_automorphism(topo: Topology, perm: Sequence[int]) -> bool:
    """Verify ``perm`` maps the topology onto itself: node attributes are
    preserved and the multiset of (src, dst, alpha, beta) link signatures is
    invariant. This is the safety gate for cache sharing."""
    n = topo.num_nodes
    if len(perm) != n or sorted(perm) != list(range(n)):
        return False
    for node in topo.nodes:
        img = topo.nodes[perm[node.id]]
        if (node.type, node.buffer_limit, node.multicast) != (
                img.type, img.buffer_limit, img.multicast):
            return False
    orig = Counter((l.src, l.dst, l.alpha, l.beta) for l in topo.links)
    mapped = Counter(
        (perm[l.src], perm[l.dst], l.alpha, l.beta) for l in topo.links
    )
    return orig == mapped


def _compose(p: tuple[int, ...], q: tuple[int, ...]) -> tuple[int, ...]:
    """(p ∘ q)(i) = p[q[i]]."""
    return tuple(p[x] for x in q)


def enumerate_automorphisms(
    topo: Topology, limit: int = _MAX_AUTOMORPHISMS
) -> list[tuple[int, ...]]:
    """Closure of the topology's declared (and verified) symmetry generators,
    including the identity. Cached on the topology object."""
    cached = getattr(topo, "_automorphism_closure", None)
    if cached is not None:
        return cached
    identity = tuple(range(topo.num_nodes))
    gens = [
        tuple(g) for g in getattr(topo, "automorphism_generators", [])
        if is_automorphism(topo, g)
    ]
    closure = {identity}
    frontier = [identity]
    while frontier and len(closure) < limit:
        nxt = []
        for p in frontier:
            for g in gens:
                q = _compose(g, p)
                if q not in closure:
                    closure.add(q)
                    nxt.append(q)
                    if len(closure) >= limit:
                        break
            if len(closure) >= limit:
                break
        frontier = nxt
    result = sorted(closure)
    topo._automorphism_closure = result
    return result


def canonicalize_group(
    topo: Topology, group: Sequence[int]
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Return ``(canonical_group, perm)`` where ``perm`` is a verified
    automorphism and ``canonical_group[i] == perm[group[i]]`` is the
    lexicographically smallest image of the (ordered) group over the
    topology's enumerated symmetries. Isomorphic process groups — e.g. the
    rows of a torus — share one canonical form."""
    group = list(group)
    best_perm = tuple(range(topo.num_nodes))
    best = tuple(group)
    for perm in enumerate_automorphisms(topo):
        img = tuple(perm[g] for g in group)
        if img < best:
            best, best_perm = img, perm
    return best, best_perm


def invert_permutation(perm: Sequence[int]) -> tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


# ---------------------------------------------------------------------------
# Algorithm relabeling
# ---------------------------------------------------------------------------

def _link_map(topo: Topology, node_map: Sequence[int]) -> list[int]:
    """Induced bijection on link ids for an automorphism ``node_map``.

    Parallel links with identical (src, dst, alpha, beta) are matched by
    ordinal, which is a consistent bijection because their attributes are
    interchangeable."""
    by_sig: dict[tuple, list[int]] = {}
    for l in topo.links:
        by_sig.setdefault((l.src, l.dst, l.alpha, l.beta), []).append(l.id)
    mapped = [0] * topo.num_links
    ordinal: dict[tuple, int] = {}
    for l in topo.links:
        sig = (l.src, l.dst, l.alpha, l.beta)
        k = ordinal.get(sig, 0)
        ordinal[sig] = k + 1
        target_sig = (node_map[l.src], node_map[l.dst], l.alpha, l.beta)
        mapped[l.id] = by_sig[target_sig][k]
    return mapped


def relabel_algorithm(
    alg: CollectiveAlgorithm,
    node_map: Sequence[int],
    *,
    chunk_map: dict[int, int] | None = None,
) -> CollectiveAlgorithm:
    """Relabel an algorithm through a topology automorphism (and optionally a
    chunk-id remap). Transfer times are untouched, so the makespan — and
    every validator invariant — is preserved by construction."""
    topo = alg.topology
    links = _link_map(topo, node_map)
    cm = chunk_map or {}

    def ch(c: int) -> int:
        return cm.get(c, c)

    conds = []
    for c in alg.conditions:
        if isinstance(c, ReduceCondition):
            conds.append(replace(
                c, chunk=ch(c.chunk),
                srcs=frozenset(node_map[s] for s in c.srcs),
                dests=frozenset(node_map[d] for d in c.dests),
            ))
        else:
            conds.append(replace(
                c, chunk=ch(c.chunk), src=node_map[c.src],
                dests=frozenset(node_map[d] for d in c.dests),
            ))
    cols = alg.columns.relabeled(node_map=node_map, link_map=links,
                                 chunk_map=cm)
    return CollectiveAlgorithm(topo, conds, cols, name=alg.name,
                               phase_spans=list(alg.phase_spans))


def renumber_chunks(
    alg: CollectiveAlgorithm, ids: ChunkIds | None
) -> CollectiveAlgorithm:
    """Remap chunk ids through the caller's allocator (condition order), so
    registry-returned algorithms compose with joint synthesis."""
    if ids is None:
        return alg
    mapping = {c.chunk: ids.next() for c in alg.conditions}
    if all(k == v for k, v in mapping.items()):
        return alg
    conds = [replace(c, chunk=mapping[c.chunk]) for c in alg.conditions]
    c = alg.columns
    cols = TransferColumns(remap_ids(c.chunk, mapping), c.link, c.src,
                           c.dst, c.start, c.end, c.reduce)
    return CollectiveAlgorithm(alg.topology, conds, cols, name=alg.name,
                               phase_spans=list(alg.phase_spans))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@dataclass
class RegistryStats:
    hits: int = 0
    misses: int = 0
    disk_hits: int = 0
    evictions: int = 0
    bytes_loaded: int = 0  # on-disk bytes of entries served from the cache dir
    bytes_stored: int = 0  # on-disk bytes written for fresh syntheses
    disk_evictions: int = 0  # entries removed by the size-capped disk LRU
    disk_bytes: int = 0  # cache-dir size after the last store/evict sweep

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "disk_hits": self.disk_hits, "evictions": self.evictions,
                "bytes_loaded": self.bytes_loaded,
                "bytes_stored": self.bytes_stored,
                "disk_evictions": self.disk_evictions,
                "disk_bytes": self.disk_bytes}


class AlgorithmRegistry:
    """LRU cache of canonical synthesized algorithms, keyed by fingerprint.

    ``get_or_synthesize`` is the single entry point: it canonicalizes the
    process group, consults memory then disk, synthesizes on the canonical
    labels only on a true miss, and relabels the result back to the caller's
    group. Lookups are serialized on an internal lock, so one registry can
    be shared across threads (the plan service's ``warm()`` workers rely on
    this); the on-disk side is safe across *processes* as well — writes are
    atomic renames, and corrupt/partial entries are dropped + resynthesized.
    """

    def __init__(self, max_entries: int = 256, cache_dir: str | None = None,
                 max_disk_bytes: int | None = None):
        self.max_entries = max_entries
        self.cache_dir = cache_dir
        if max_disk_bytes is None:
            env = os.environ.get("PCCL_CACHE_MAX_BYTES", "").strip()
            if env:
                try:
                    max_disk_bytes = int(env)
                except ValueError:
                    max_disk_bytes = None
        self.max_disk_bytes = max_disk_bytes
        self.stats = RegistryStats()
        self._lru: OrderedDict[tuple, CollectiveAlgorithm] = OrderedDict()
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self.stats = RegistryStats()

    # -- key construction ---------------------------------------------------

    @staticmethod
    def _key(topo: Topology, kind: str, canon: tuple[int, ...],
             params: tuple) -> tuple:
        return (SCHEMA_VERSION, topology_fingerprint(topo), kind, canon,
                params)

    @staticmethod
    def fingerprint(topo: Topology, kind: str, group: Sequence[int],
                    params: tuple = ()) -> str:
        """Stable hex fingerprint of a canonicalized request (also the
        on-disk file stem)."""
        canon, _ = canonicalize_group(topo, group)
        key = AlgorithmRegistry._key(topo, kind, canon, params)
        return hashlib.sha256(repr(key).encode()).hexdigest()

    # -- disk persistence ---------------------------------------------------

    def _disk_path(self, key: tuple) -> str | None:
        if self.cache_dir is None:
            return None
        stem = hashlib.sha256(repr(key).encode()).hexdigest()
        return os.path.join(self.cache_dir, f"{stem}.npz")

    # -- disk-tier LRU eviction ---------------------------------------------
    #
    # A shared PCCL_CACHE_DIR grows without bound as fabrics and schema
    # versions churn, so the disk tier is size-capped (``max_disk_bytes`` /
    # ``PCCL_CACHE_MAX_BYTES``): every load and store stamps the entry's
    # access time into a manifest (atomic rename, last writer wins —
    # approximate LRU is all eviction needs), and each store sweeps the
    # directory, removing the stalest entries until the cap holds. The
    # sweep is safe under concurrent readers and a churning writer: a file
    # another process already evicted is simply skipped, a reader that
    # loses a race re-synthesizes (the registry already tolerates missing
    # entries), and the manifest tolerates corruption by rebuilding.

    def _manifest_path(self) -> str:
        return os.path.join(self.cache_dir, "manifest.json")

    def _read_manifest(self) -> dict[str, float]:
        try:
            with open(self._manifest_path(), encoding="utf-8") as f:
                man = json.load(f)
            return {str(k): float(v) for k, v in man.items()}
        except (OSError, ValueError, TypeError):
            # missing (fresh dir) or corrupt (killed writer): entries
            # unknown to the manifest rank oldest, so a rebuilt manifest
            # only makes eviction more conservative, never wrong
            return {}

    def _write_manifest(self, man: dict[str, float]) -> None:
        mf = self._manifest_path()
        tmp = f"{mf}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(man, f)
            os.replace(tmp, mf)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def _touch_manifest(self, path: str) -> None:
        """Stamp ``path``'s access time into the shared manifest."""
        if self.cache_dir is None or self.max_disk_bytes is None:
            return
        man = self._read_manifest()
        man[os.path.basename(path)] = time.time()
        self._write_manifest(man)

    def _evict_disk(self, keep: str | None = None) -> None:
        """Sweep the cache dir down to ``max_disk_bytes``, stalest-first
        by manifest access time (``keep`` — the entry just written — is
        never evicted). Missing files are tolerated: another process may
        have evicted them first."""
        cap = self.max_disk_bytes
        if cap is None or self.cache_dir is None:
            return
        try:
            names = [n for n in os.listdir(self.cache_dir)
                     if n.endswith(".npz")]
        except OSError:
            return
        sizes: dict[str, int] = {}
        total = 0
        for n in names:
            try:
                sz = os.path.getsize(os.path.join(self.cache_dir, n))
            except OSError:
                continue  # evicted under our feet
            sizes[n] = sz
            total += sz
        man = self._read_manifest()
        if total > cap:
            for n in sorted(sizes, key=lambda n: (man.get(n, 0.0), n)):
                if total <= cap:
                    break
                if n == keep:
                    continue
                try:
                    os.remove(os.path.join(self.cache_dir, n))
                except OSError:
                    pass  # a concurrent evictor got there first
                total -= sizes[n]
                man.pop(n, None)
                self.stats.disk_evictions += 1
            self._write_manifest(man)
        self.stats.disk_bytes = total

    def _load_disk(self, key: tuple, topo: Topology) -> CollectiveAlgorithm | None:
        path = self._disk_path(key)
        if path is None:
            return None
        if os.path.exists(path):
            from repro_torch.core.serialize import load_plan_npz

            try:
                nbytes = os.path.getsize(path)
                alg = load_plan_npz(path, topo)
                self.stats.bytes_loaded += nbytes
                self._touch_manifest(path)
                return alg
            except (OSError, ValueError, KeyError, TypeError, AttributeError,
                    IndexError):
                # Corrupt, truncated, or wrong-shape entry (a half-written
                # file from a killed process, bit rot, a hand-edited file):
                # never fail the lookup — drop the bad entry so the fresh
                # plan replaces it, and resynthesize.
                try:
                    os.remove(path)
                except OSError:
                    pass
                return None
        return self._load_legacy_json(key, topo)

    def _load_legacy_json(self, key: tuple,
                          topo: Topology) -> CollectiveAlgorithm | None:
        """Back-compat import of a pre-npz ``.json`` entry; on success the
        plan is re-stored as npz and the JSON file retired (one-way
        migration)."""
        path = self._disk_path(key)
        jpath = path[:-len(".npz")] + ".json" if path else None
        if jpath is None or not os.path.exists(jpath):
            return None
        from repro_torch.core.translate import from_msccl_json

        try:
            nbytes = os.path.getsize(jpath)
            with open(jpath, encoding="utf-8") as f:
                alg = from_msccl_json(f.read(), topo)
            self.stats.bytes_loaded += nbytes
        except (OSError, ValueError, KeyError, TypeError, AttributeError,
                IndexError):
            try:
                os.remove(jpath)
            except OSError:
                pass
            return None
        self._store_disk(key, alg)
        try:
            os.remove(jpath)
        except OSError:
            pass
        return alg

    def _store_disk(self, key: tuple, alg: CollectiveAlgorithm) -> None:
        path = self._disk_path(key)
        if path is None:
            return
        from repro_torch.core.serialize import save_plan_npz

        os.makedirs(self.cache_dir, exist_ok=True)
        # >>> copy fix: _store_disk race
        # The temporary name is unique per thread as well as per process, and
        # the size is taken from it before the rename: another process may
        # replace or evict ``path`` as soon as it exists.
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            save_plan_npz(tmp, alg, key[1])
            size = os.path.getsize(tmp)
            os.replace(tmp, path)
        except OSError:
            # disk-full / permission trouble degrades to a memory-only cache
            try:
                os.remove(tmp)
            except OSError:
                pass
            return
        self.stats.bytes_stored += size
        # <<< copy fix
        self._touch_manifest(path)
        self._evict_disk(keep=os.path.basename(path))

    # -- main entry ---------------------------------------------------------

    def get_or_synthesize(
        self,
        topo: Topology,
        kind: str,
        group: Sequence[int],
        synth: Callable[[list[int]], CollectiveAlgorithm],
        *,
        params: tuple = (),
        ids: ChunkIds | None = None,
    ) -> CollectiveAlgorithm:
        """Fetch (or synthesize and cache) the algorithm for ``kind`` over
        ``group``. ``synth`` receives the canonicalized group (the images of
        ``group``'s members, in order) and must build conditions with a fresh
        ``ChunkIds()`` so cached chunk ids are dense from 0."""
        group = list(group)
        canon, perm = canonicalize_group(topo, group)
        key = self._key(topo, kind, canon, params)

        with self._lock:
            alg = self._lru.get(key)
            if alg is not None:
                self._lru.move_to_end(key)
                self.stats.hits += 1
            else:
                alg = self._load_disk(key, topo)
                if alg is not None:
                    self.stats.disk_hits += 1
                else:
                    alg = synth(list(canon))
                    self.stats.misses += 1
                    self._store_disk(key, alg)
                self._lru[key] = alg
                while len(self._lru) > self.max_entries:
                    self._lru.popitem(last=False)
                    self.stats.evictions += 1

        if canon != tuple(group):
            alg = relabel_algorithm(alg, invert_permutation(perm))
        return renumber_chunks(alg, ids)


_DEFAULT_REGISTRY: AlgorithmRegistry | None = None
_DEFAULT_REGISTRY_LOCK = threading.Lock()


def default_registry() -> AlgorithmRegistry:
    """Process-wide shared registry (used by repro.comms and repro.launch).

    Set ``PCCL_CACHE_DIR`` to persist synthesized algorithms across runs.
    """
    global _DEFAULT_REGISTRY
    with _DEFAULT_REGISTRY_LOCK:
        if _DEFAULT_REGISTRY is None:
            _DEFAULT_REGISTRY = AlgorithmRegistry(
                cache_dir=os.environ.get("PCCL_CACHE_DIR") or None
            )
        return _DEFAULT_REGISTRY
