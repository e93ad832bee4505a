"""Condition-based collective representation (paper §4.1, Fig. 5).

Preconditions/postconditions are NPU-centric; PCCL's *condition* view is
chunk-centric: each condition names a chunk, the NPU that initially holds it,
and the set of NPUs that must hold it afterwards. Reduction collectives are
described by :class:`ReduceCondition` — a chunk assembled from per-NPU
contributions — and are synthesized by reversing the corresponding
non-reduction algorithm (paper §4.5).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from functools import cached_property


@dataclass(frozen=True)
class Condition:
    """One chunk's journey: src NPU -> every NPU in dests.

    bytes sizes the chunk for alpha-beta timing; release is the earliest time
    the chunk may leave its source (used to compose phases, e.g. All-Reduce =
    Reduce-Scatter then All-Gather).
    """

    chunk: int
    src: int
    dests: frozenset[int]
    bytes: float = 1.0
    release: float = 0.0
    tag: str = ""

    def __post_init__(self):
        if type(self.dests) is not frozenset:
            object.__setattr__(self, "dests", frozenset(self.dests))
        if not self.dests:
            raise ValueError(f"chunk {self.chunk}: empty destination set")

    @cached_property
    def remote_dests(self) -> frozenset[int]:
        return self.dests - {self.src}


@dataclass(frozen=True)
class ReduceCondition:
    """A reduced chunk: contributions from every NPU in srcs, combined
    (associative/commutative op, e.g. add) and delivered to every NPU in dests."""

    chunk: int
    srcs: frozenset[int]
    dests: frozenset[int]
    bytes: float = 1.0
    release: float = 0.0
    tag: str = ""

    def __post_init__(self):
        object.__setattr__(self, "srcs", frozenset(self.srcs))
        object.__setattr__(self, "dests", frozenset(self.dests))
        if not self.srcs or not self.dests:
            raise ValueError(f"chunk {self.chunk}: empty srcs/dests")


class ChunkIds:
    """Dense unique chunk-id allocator, shared across process groups so that a
    joint synthesis over several concurrent collectives never aliases chunks.

    ``split()`` hands out child allocators that draw from the *same*
    underlying counter, so independent condition builders (one per process
    group) can be composed into a joint synthesis without hand-threading a
    single allocator through every call site — the classic collision footgun
    that ``SynthesisEngine.synthesize_joint`` rejects with a ``ValueError``.
    """

    def __init__(self, start: int = 0):
        self._counter = itertools.count(start)

    def next(self) -> int:
        return next(self._counter)

    def split(self, k: int = 2) -> "list[ChunkIds]":
        """``k`` child allocators sharing this allocator's counter: ids drawn
        from any child (or from ``self``) are globally unique."""
        if k < 1:
            raise ValueError(f"cannot split into {k} allocators")
        children = []
        for _ in range(k):
            child = ChunkIds.__new__(ChunkIds)
            child._counter = self._counter
            children.append(child)
        return children


# ---------------------------------------------------------------------------
# Collective pattern builders (paper Fig. 1 / Fig. 5). `group` is the process
# group: an ordered list of NPU ids. Chunk ids come from `ids` so multiple
# collectives can be synthesized jointly (paper §6.4, Fig. 15).
# ---------------------------------------------------------------------------

def broadcast(group: list[int], root: int, ids: ChunkIds | None = None,
              bytes: float = 1.0, tag: str = "bcast") -> list[Condition]:
    ids = ids or ChunkIds()
    return [Condition(ids.next(), root, frozenset(group), bytes, tag=tag)]


def multicast(src: int, dests: list[int], ids: ChunkIds | None = None,
              bytes: float = 1.0, tag: str = "mcast") -> list[Condition]:
    ids = ids or ChunkIds()
    return [Condition(ids.next(), src, frozenset(dests), bytes, tag=tag)]


def point_to_point(src: int, dst: int, ids: ChunkIds | None = None,
                   bytes: float = 1.0, tag: str = "p2p") -> list[Condition]:
    ids = ids or ChunkIds()
    return [Condition(ids.next(), src, frozenset([dst]), bytes, tag=tag)]


def scatter(group: list[int], root: int, ids: ChunkIds | None = None,
            bytes: float = 1.0, tag: str = "scatter") -> list[Condition]:
    ids = ids or ChunkIds()
    return [
        Condition(ids.next(), root, frozenset([dst]), bytes, tag=tag)
        for dst in group
        if dst != root
    ]


def gather(group: list[int], root: int, ids: ChunkIds | None = None,
           bytes: float = 1.0, tag: str = "gather") -> list[Condition]:
    ids = ids or ChunkIds()
    return [
        Condition(ids.next(), src, frozenset([root]), bytes, tag=tag)
        for src in group
        if src != root
    ]


def all_gather(group: list[int], ids: ChunkIds | None = None,
               bytes: float = 1.0, chunks_per_npu: int = 1,
               tag: str = "allgather") -> list[Condition]:
    ids = ids or ChunkIds()
    dests = frozenset(group)
    return [
        Condition(ids.next(), src, dests, bytes, tag=tag)
        for src in group
        for _ in range(chunks_per_npu)
    ]


def all_to_all(group: list[int], ids: ChunkIds | None = None,
               bytes: float = 1.0, chunks_per_pair: int = 1,
               tag: str = "alltoall") -> list[Condition]:
    ids = ids or ChunkIds()
    return [
        Condition(ids.next(), src, frozenset([dst]), bytes, tag=tag)
        for src in group
        for dst in group
        if src != dst
        for _ in range(chunks_per_pair)
    ]


def all_to_allv(group: list[int], counts: dict[tuple[int, int], int] | list[list[int]],
                ids: ChunkIds | None = None, bytes: float = 1.0,
                tag: str = "alltoallv") -> list[Condition]:
    """All-to-Allv: counts[(i, j)] (or counts[i][j] by group index) chunks from
    NPU i to NPU j. MoE expert-parallel dispatch is exactly this pattern."""
    ids = ids or ChunkIds()
    conds: list[Condition] = []
    if isinstance(counts, list):
        counts = {
            (group[i], group[j]): counts[i][j]
            for i in range(len(group))
            for j in range(len(group))
        }
    for (src, dst), k in sorted(counts.items()):
        if src == dst:
            continue
        for _ in range(k):
            conds.append(Condition(ids.next(), src, frozenset([dst]), bytes, tag=tag))
    return conds


def reduce(group: list[int], root: int, ids: ChunkIds | None = None,
           bytes: float = 1.0, tag: str = "reduce") -> list[ReduceCondition]:
    ids = ids or ChunkIds()
    return [ReduceCondition(ids.next(), frozenset(group), frozenset([root]), bytes, tag=tag)]


def reduce_scatter(group: list[int], ids: ChunkIds | None = None,
                   bytes: float = 1.0, chunks_per_npu: int = 1,
                   tag: str = "reducescatter") -> list[ReduceCondition]:
    ids = ids or ChunkIds()
    srcs = frozenset(group)
    return [
        ReduceCondition(ids.next(), srcs, frozenset([owner]), bytes, tag=tag)
        for owner in group
        for _ in range(chunks_per_npu)
    ]


def all_reduce(group: list[int], ids: ChunkIds | None = None,
               bytes: float = 1.0, chunks_per_npu: int = 1,
               tag: str = "allreduce") -> list[ReduceCondition]:
    ids = ids or ChunkIds()
    srcs = frozenset(group)
    dests = frozenset(group)
    return [
        ReduceCondition(ids.next(), srcs, dests, bytes, tag=tag)
        for _ in group
        for _ in range(chunks_per_npu)
    ]


def with_release(conds: list[Condition], release: float) -> list[Condition]:
    return [replace(c, release=release) for c in conds]


def gather_view(rconds: list[ReduceCondition],
                tag: str = "rev_gather") -> list[Condition]:
    """The broadcast/gather dual of single-destination reduce conditions.

    PCCL synthesizes reductions by reversal (paper §4.5): a chunk reduced
    from ``srcs`` onto one root is the time-reversal of that chunk being
    multicast from the root to ``srcs`` on the link-reversed fabric. This
    helper produces those dual conditions — chunk ids carry over, so the
    reversed schedule maps back onto the reduce conditions positionally.
    Both the flat engine internals and the hierarchical pipeline share it.
    """
    out = []
    for r in rconds:
        if len(r.dests) != 1:
            raise ValueError(
                f"chunk {r.chunk}: gather_view needs a single reduction "
                f"root, got dests={sorted(r.dests)}"
            )
        out.append(Condition(r.chunk, next(iter(r.dests)), r.srcs,
                             bytes=r.bytes, tag=tag))
    return out
