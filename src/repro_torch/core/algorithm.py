"""Synthesized collective algorithms: timed chunk transfers + validation oracle.

A synthesized algorithm is a congestion-free schedule of store-and-forward
chunk transfers over physical links. ``validate()`` replays the schedule and
checks every invariant the synthesizer promises:

  * links exist and transfer durations follow the alpha-beta model,
  * no two transfers overlap on one link (congestion-freedom, paper §4.4),
  * store-and-forward causality (a chunk leaves a device only after arriving),
  * switch buffer limits and multicast capability (paper §4.7),
  * post-conditions: every destination holds its chunk; reduced chunks carry
    each contribution exactly once (no double counting).

Storage is **columnar**: the source of truth for a schedule is a
:class:`TransferColumns` struct of parallel numpy arrays
(``chunk/link/src/dst/start/end/reduce``), ~37 bytes/row instead of the
~150+ bytes a boxed :class:`Transfer` object costs. Every aggregate
(`makespan`, `link_busy_time`, bulk validation, sorting) runs directly on
the arrays; the object API survives through :class:`TransferList`, a lazy
``Sequence[Transfer]`` view that materializes rows on demand.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np

from repro_torch.core.conditions import Condition, ReduceCondition
from repro_torch.topology.topology import Topology

_EPS = 1e-6

# historical threshold between the object-sort and lexsort paths; sorting is
# always columnar now, but `validate(mode="auto")` still uses it as the
# schedule size past which the vectorized validator takes over
_VECTOR_SORT_MIN = 1 << 17

# row block size for the lazy Transfer iterator: tolist() per block keeps
# python-object churn off the hot loop without materializing the whole plan
_ITER_BLOCK = 1 << 16


class _NotInForest(Exception):
    """Internal: a reduction schedule is not in the in-forest normal form
    the bulk validator's structural shortcut covers — defer the verdict to
    the reference oracle (which rejects the genuinely broken schedules and
    accepts valid-but-nonstandard ones)."""


@dataclass(frozen=True, slots=True)
class Transfer:
    """Chunk moves src -> dst over `link` during [start, end)."""

    chunk: int
    link: int
    src: int
    dst: int
    start: float
    end: float
    reduce: bool = False

    def overlaps(self, other: "Transfer") -> bool:
        return self.start < other.end - _EPS and other.start < self.end - _EPS


# columnar field order and dtypes; link/src/dst are int32 (fabrics stay well
# under 2^31 links), chunk is int64 (hierarchical compositions renumber into
# wide global id spaces)
_COLUMN_DTYPES = (
    ("chunk", np.int64),
    ("link", np.int32),
    ("src", np.int32),
    ("dst", np.int32),
    ("start", np.float64),
    ("end", np.float64),
    ("reduce", np.bool_),
)


def remap_ids(values: np.ndarray, mapping: dict) -> np.ndarray:
    """Vectorized ``mapping.get(v, v)`` over an int array: ids present in
    `mapping` are translated, everything else passes through unchanged."""
    if not len(mapping) or not len(values):
        return values
    keys = np.fromiter(mapping.keys(), np.int64, len(mapping))
    vals = np.fromiter(mapping.values(), np.int64, len(mapping))
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    pos = np.searchsorted(keys, values)
    pos_c = np.minimum(pos, len(keys) - 1)
    hit = keys[pos_c] == values
    return np.where(hit, vals[pos_c], values)


class TransferColumns:
    """Parallel arrays holding one schedule: the columnar source of truth.

    Arrays are treated as immutable after construction (they may be
    zero-copy views into an mmap'ed registry entry) — every transform
    (`shifted`, `take`, `relabeled`, ...) returns a new instance, sharing
    unchanged columns. ``presorted`` records that rows are already in the
    canonical ``(start, chunk, link)`` schedule order, letting loads of
    persisted plans skip the sort (and the page-in it would force).
    """

    __slots__ = ("chunk", "link", "src", "dst", "start", "end", "reduce",
                 "presorted")

    def __init__(self, chunk, link, src, dst, start, end, reduce, *,
                 presorted: bool = False):
        self.chunk = np.asarray(chunk, np.int64)
        self.link = np.asarray(link, np.int32)
        self.src = np.asarray(src, np.int32)
        self.dst = np.asarray(dst, np.int32)
        self.start = np.asarray(start, np.float64)
        self.end = np.asarray(end, np.float64)
        self.reduce = np.asarray(reduce, np.bool_)
        self.presorted = presorted

    # -- construction --------------------------------------------------
    @classmethod
    def empty(cls) -> "TransferColumns":
        return cls(*(np.empty(0, dt) for _, dt in _COLUMN_DTYPES),
                   presorted=True)

    @classmethod
    def from_transfers(cls, transfers) -> "TransferColumns":
        ts = transfers if isinstance(transfers, (list, tuple)) \
            else list(transfers)
        n = len(ts)
        if not n:
            return cls.empty()
        return cls(
            np.fromiter((t.chunk for t in ts), np.int64, n),
            np.fromiter((t.link for t in ts), np.int32, n),
            np.fromiter((t.src for t in ts), np.int32, n),
            np.fromiter((t.dst for t in ts), np.int32, n),
            np.fromiter((t.start for t in ts), np.float64, n),
            np.fromiter((t.end for t in ts), np.float64, n),
            np.fromiter((t.reduce for t in ts), np.bool_, n),
        )

    @classmethod
    def concat(cls, blocks: list) -> "TransferColumns":
        blocks = [b for b in blocks if len(b)]
        if not blocks:
            return cls.empty()
        if len(blocks) == 1:
            return blocks[0]
        return cls(*(np.concatenate([getattr(b, f) for b in blocks])
                     for f, _ in _COLUMN_DTYPES))

    # -- basics --------------------------------------------------------
    def __len__(self) -> int:
        return len(self.chunk)

    @property
    def nbytes(self) -> int:
        """Bytes held by the seven column arrays (the plan's working set)."""
        return sum(getattr(self, f).nbytes for f, _ in _COLUMN_DTYPES)

    def row(self, i: int) -> Transfer:
        return Transfer(int(self.chunk[i]), int(self.link[i]),
                        int(self.src[i]), int(self.dst[i]),
                        float(self.start[i]), float(self.end[i]),
                        bool(self.reduce[i]))

    # -- transforms (all pure) -----------------------------------------
    def take(self, order: np.ndarray, *,
             presorted: bool = False) -> "TransferColumns":
        return TransferColumns(*(getattr(self, f)[order]
                                 for f, _ in _COLUMN_DTYPES),
                               presorted=presorted)

    def sorted_schedule(self) -> "TransferColumns":
        """Rows in canonical ``(start, chunk, link)`` order — the same
        stable order ``sorted(key=attrgetter("start", "chunk", "link"))``
        produced on the object path (``np.lexsort`` is stable)."""
        if self.presorted or len(self) <= 1:
            self.presorted = True
            return self
        order = np.lexsort((self.link, self.chunk, self.start))
        if np.array_equal(order, np.arange(len(order))):
            self.presorted = True
            return self
        return self.take(order, presorted=True)

    def shifted(self, dt: float) -> "TransferColumns":
        if dt == 0.0:
            return self
        return TransferColumns(self.chunk, self.link, self.src, self.dst,
                               self.start + dt, self.end + dt, self.reduce,
                               presorted=self.presorted)

    def relabeled(self, node_map=None, link_map=None,
                  chunk_map=None, shift: float = 0.0) -> "TransferColumns":
        """Apply id translations (and an optional time shift) in one pass:
        `node_map`/`link_map` are dense old->new arrays or sequences,
        `chunk_map` a sparse dict (ids absent from it pass through)."""
        chunk = self.chunk if not chunk_map \
            else remap_ids(self.chunk, chunk_map)
        link, src, dst = self.link, self.src, self.dst
        if link_map is not None:
            link = np.asarray(link_map, np.int64)[link].astype(np.int32)
        if node_map is not None:
            nm = np.asarray(node_map, np.int64)
            src = nm[src].astype(np.int32)
            dst = nm[dst].astype(np.int32)
        start, end = self.start, self.end
        if shift != 0.0:
            start, end = start + shift, end + shift
        return TransferColumns(chunk, link, src, dst, start, end, self.reduce)

    def time_reversed(self, pivot: float) -> "TransferColumns":
        """The reversed-schedule transform behind Reduce-Scatter synthesis:
        every transfer flips direction, runs reduce-flagged in the mirrored
        window ``[pivot - end, pivot - start)``."""
        return TransferColumns(self.chunk, self.link, self.dst, self.src,
                               pivot - self.end, pivot - self.start,
                               np.ones(len(self), np.bool_))


class TransferList(Sequence):
    """Lazy ``Sequence[Transfer]`` view over :class:`TransferColumns`.

    Rows are materialized on access only; iteration materializes in
    blocks so per-row numpy scalar boxing stays off the hot path. Equality
    against another view compares the arrays (no objects built at all);
    equality against a plain list compares element-wise."""

    __slots__ = ("columns",)

    def __init__(self, columns: TransferColumns):
        self.columns = columns

    def __len__(self) -> int:
        return len(self.columns)

    def __getitem__(self, i):
        n = len(self.columns)
        if isinstance(i, slice):
            idx = range(*i.indices(n))
            return [self.columns.row(j) for j in idx]
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("transfer index out of range")
        return self.columns.row(i)

    def __iter__(self):
        c = self.columns
        n = len(c)
        for lo in range(0, n, _ITER_BLOCK):
            hi = min(lo + _ITER_BLOCK, n)
            yield from map(Transfer,
                           c.chunk[lo:hi].tolist(), c.link[lo:hi].tolist(),
                           c.src[lo:hi].tolist(), c.dst[lo:hi].tolist(),
                           c.start[lo:hi].tolist(), c.end[lo:hi].tolist(),
                           c.reduce[lo:hi].tolist())

    def __eq__(self, other) -> bool:
        if isinstance(other, TransferList):
            a, b = self.columns, other.columns
            return len(a) == len(b) and all(
                np.array_equal(getattr(a, f), getattr(b, f))
                for f, _ in _COLUMN_DTYPES)
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                x == y for x, y in zip(self, other))
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None

    def __add__(self, other):
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)

    def __repr__(self) -> str:
        return f"TransferList(n={len(self)})"


def _as_columns(transfers) -> TransferColumns:
    if transfers is None:
        return TransferColumns.empty()
    if isinstance(transfers, TransferColumns):
        return transfers
    if isinstance(transfers, TransferList):
        return transfers.columns
    return TransferColumns.from_transfers(transfers)


class CollectiveAlgorithm:
    """The synthesis result for a set of conditions over a topology.

    ``transfers`` accepts a list of :class:`Transfer`, a
    :class:`TransferColumns`, or another algorithm's :class:`TransferList`;
    it is stored columnar (``self.columns``) in canonical schedule order
    and exposed back through the lazy ``transfers`` view.
    """

    __slots__ = ("topology", "conditions", "columns", "name", "phase_spans")

    def __init__(self, topology: Topology, conditions: list, transfers=None,
                 name: str = "pccl", phase_spans: list | None = None):
        self.topology = topology
        self.conditions = list(conditions)
        self.name = name
        # Phase provenance for composed algorithms (hierarchical / PhasePlan
        # synthesis): [(phase name, first start, last end)], in execution
        # order. Multi-level compositions record sub-phase provenance as
        # nested "parent/child" names (e.g. "intra:0/inter" — the
        # pod-boundary phase inside pod 0's recursive plan), whose windows
        # lie inside the parent's. Purely descriptive — validation and
        # replay never consult it.
        self.phase_spans = list(phase_spans) if phase_spans else []
        self.columns = _as_columns(transfers).sorted_schedule()

    @property
    def transfers(self) -> TransferList:
        return TransferList(self.columns)

    def __eq__(self, other) -> bool:
        if not isinstance(other, CollectiveAlgorithm):
            return NotImplemented
        return (self.topology == other.topology
                and self.conditions == other.conditions
                and self.transfers == other.transfers
                and self.name == other.name
                and self.phase_spans == other.phase_spans)

    __hash__ = None

    def __repr__(self) -> str:
        return (f"CollectiveAlgorithm(name={self.name!r}, "
                f"conditions={len(self.conditions)}, "
                f"transfers={len(self.columns)})")

    def top_phase_spans(self) -> list:
        """Top-level ``phase_spans`` entries only — nested sub-phase
        provenance (recorded as ``"parent/child"`` names by multi-level
        composition) filtered out."""
        return [s for s in self.phase_spans if "/" not in s[0]]

    @property
    def makespan(self) -> float:
        if not len(self.columns):
            return 0.0
        release = min((c.release for c in self.conditions), default=0.0)
        return float(self.columns.end.max()) - release

    @property
    def num_transfers(self) -> int:
        return len(self.columns)

    @property
    def plan_nbytes(self) -> int:
        """In-memory footprint of the columnar schedule."""
        return self.columns.nbytes

    def total_bytes_moved(self) -> float:
        cols = self.columns
        if not len(cols):
            return 0.0
        sizes = {c.chunk: c.bytes for c in self.conditions}
        ck = np.fromiter(sizes.keys(), np.int64, len(sizes))
        cb = np.fromiter(sizes.values(), np.float64, len(sizes))
        order = np.argsort(ck)
        ck, cb = ck[order], cb[order]
        return float(cb[np.searchsorted(ck, cols.chunk)].sum())

    def link_busy_time(self) -> dict[int, float]:
        cols = self.columns
        if not len(cols):
            return {}
        busy = np.zeros(self.topology.num_links, np.float64)
        np.add.at(busy, cols.link, cols.end - cols.start)
        present = np.unique(cols.link)
        return dict(zip(present.tolist(), busy[present].tolist()))

    def link_utilization(self) -> dict[int, float]:
        span = self.makespan or 1.0
        return {l: b / span for l, b in self.link_busy_time().items()}

    # ------------------------------------------------------------------
    # Validation oracle
    # ------------------------------------------------------------------
    def validate(self, mode: str = "auto") -> None:
        """Replay the schedule and check every synthesizer invariant.

        ``mode="auto"`` dispatches million-transfer schedules of the
        *unconstrained* class (every switch unlimited and
        multicast-capable; reductions in the in-forest normal form PCCL
        synthesizes) to a vectorized implementation of the same checks —
        identical accept/reject behavior, enforced by the differential
        tests in ``tests/test_validation_bulk.py`` — and everything else
        to the reference oracle. ``"oracle"``/``"bulk"`` force a path."""
        if mode not in ("auto", "oracle", "bulk"):
            raise ValueError(f"mode={mode!r} not in auto/oracle/bulk")
        if mode == "oracle":
            return self._validate_oracle()
        eligible = (
            len(self.columns) >= _VECTOR_SORT_MIN or mode == "bulk"
        ) and self._bulk_validatable()
        if mode == "bulk" and not eligible:
            raise ValueError(
                "bulk validation requires plain/reduce conditions and "
                "unconstrained switches"
            )
        if eligible:
            return self._validate_bulk()
        return self._validate_oracle()

    def _bulk_validatable(self) -> bool:
        if not all(n.buffer_limit is None and n.multicast
                   for n in self.topology.nodes):
            return False
        if not all(type(c) in (Condition, ReduceCondition)
                   for c in self.conditions):
            return False
        # reduce transfers must ride reduction chunks — a reduce-flagged
        # copy of a plain chunk is a nonstandard schedule the oracle judges
        # with its full replay, so keep it there
        cols = self.columns
        if not cols.reduce.any():
            return True
        rchunks = sorted(c.chunk for c in self.conditions
                         if type(c) is ReduceCondition)
        if not rchunks:
            return False
        rarr = np.asarray(rchunks, np.int64)
        rc = cols.chunk[cols.reduce]
        loc = np.minimum(np.searchsorted(rarr, rc), len(rarr) - 1)
        return bool((rarr[loc] == rc).all())

    def _validate_bulk(self) -> None:
        """Vectorized validation for schedules on unconstrained fabrics.
        Check-for-check equivalent to the oracle: link endpoints and
        alpha-beta durations, adjacent-interval congestion per link, release
        bounds, store-and-forward causality (a chunk departs a node only
        at/after its earliest arrival there), and post-condition delivery.

        Reduction schedules are checked against the in-forest normal form
        every PCCL reduction synthesizes (flat reversed-gather and
        hierarchical phase-composed alike): per chunk, reduce transfers form
        an in-forest in which each device forwards its accumulated partial
        at most once and only after every partial merged into it arrived;
        all chains terminate at a single root, where the full contribution
        set assembles; plain copies of the chunk flow only from that root,
        no earlier than assembly. Within that class the verdict matches the
        oracle's replay (each contribution delivered exactly once, no
        partial-state copies). A schedule outside the normal form — e.g. a
        hand-written one that reduce-forwards an already-assembled chunk —
        is handed to the oracle for the final verdict instead of being
        rejected structurally, so ``validate`` returns the same answer at
        every size and through every mode."""
        topo = self.topology
        ts = self.transfers
        conds = self.conditions
        cols = self.columns
        n = len(cols)
        chunk, link = cols.chunk, cols.link
        src, dst = cols.src, cols.dst
        start, end, red = cols.start, cols.end, cols.reduce

        if n and (link.min() < 0 or link.max() >= topo.num_links):
            raise AssertionError("transfer references unknown link")
        lsrc = np.fromiter((l.src for l in topo.links), np.int64,
                           topo.num_links)
        ldst = np.fromiter((l.dst for l in topo.links), np.int64,
                           topo.num_links)
        bad = (lsrc[link] != src) | (ldst[link] != dst)
        if bad.any():
            raise AssertionError(
                f"{ts[int(bad.argmax())]} does not ride its link")

        cchunk = np.fromiter((c.chunk for c in conds), np.int64, len(conds))
        uchunks, cidx = np.unique(cchunk, return_index=True)
        if len(uchunks) != len(conds):
            raise AssertionError("duplicate chunk id in conditions")
        pos = np.searchsorted(uchunks, chunk)
        if n and ((pos >= len(uchunks)) | (uchunks[np.minimum(
                pos, len(uchunks) - 1)] != chunk)).any():
            raise AssertionError("transfer moves unknown chunk")
        csize = np.fromiter((c.bytes for c in conds), float, len(conds))
        crel = np.fromiter((c.release for c in conds), float, len(conds))
        sizes = csize[cidx][pos] if n else csize[:0]
        rel = crel[cidx][pos] if n else crel[:0]

        alpha = np.fromiter((l.alpha for l in topo.links), float,
                            topo.num_links)
        beta = np.fromiter((l.beta for l in topo.links), float,
                           topo.num_links)
        want = alpha[link] + sizes * beta[link]
        bad = np.abs((end - start) - want) > _EPS
        if bad.any():
            k = int(bad.argmax())
            raise AssertionError(
                f"{ts[k]}: duration {end[k] - start[k]} != alpha-beta "
                f"time {want[k]}")

        # congestion: per link, adjacent intervals in start order
        order = np.lexsort((start, link))
        ls, ss, es = link[order], start[order], end[order]
        same = ls[1:] == ls[:-1]
        overlap = same & (ss[1:] < es[:-1] - _EPS) & (ss[:-1] < es[1:] - _EPS)
        if overlap.any():
            k = int(overlap.argmax())
            raise AssertionError(
                f"congestion on link {ls[k]}: {ts[int(order[k])]} vs "
                f"{ts[int(order[k + 1])]}")

        if (start < rel - _EPS).any():
            k = int((start < rel - _EPS).argmax())
            raise AssertionError(f"{ts[k]}: starts before chunk release")

        nn = topo.num_nodes
        # per-upos condition views (uchunks[j] is the chunk of conds[cidx[j]])
        is_rc_u = np.fromiter(
            (type(conds[i]) is ReduceCondition for i in cidx), bool,
            len(cidx))
        origin_u = np.fromiter(
            (getattr(conds[i], "src", -1) for i in cidx), np.int64, len(cidx))
        rel_u = crel[cidx]
        rel_eff_u = rel_u

        # -- reduction algebra: in-forest per chunk -------------------------
        if is_rc_u.any():
            try:
                origin_u, rel_eff_u = self._bulk_reduce_structure(
                    conds, cidx, uchunks, is_rc_u, origin_u, rel_u,
                    pos, src, dst, start, end, red, nn)
            except _NotInForest:
                # outside the normal form PCCL synthesizes: the structural
                # shortcut does not apply, so the reference replay decides
                return self._validate_oracle()

        # earliest copy arrival per (chunk, node), origins at release (for
        # reduced chunks: at the root, at assembly time)
        cp = np.nonzero(~red)[0]
        akey = (pos * nn + dst)[cp]
        ukey, inv = np.unique(akey, return_inverse=True)
        amin = np.full(len(ukey), np.inf)
        np.minimum.at(amin, inv, end[cp])

        if len(cp):
            origin_t = origin_u[pos[cp]]
            rel_eff_t = rel_eff_u[pos[cp]]
            skey2 = (pos * nn + src)[cp]
            if len(ukey):
                sloc = np.minimum(np.searchsorted(ukey, skey2),
                                  len(ukey) - 1)
                found = ukey[sloc] == skey2
                arr = np.where(found, amin[sloc], np.inf)
            else:
                arr = np.full(len(cp), np.inf)
            arr = np.where(src[cp] == origin_t,
                           np.minimum(arr, rel_eff_t), arr)
            bad = start[cp] < arr - _EPS
            if bad.any():
                # a "bad" copy of a reduced chunk may be legal outside the
                # normal form (a mid-chain node that assembled the full set
                # may copy it onward) — the oracle decides those; a bad copy
                # of a plain chunk is a definite causality violation
                bad_plain = bad & ~is_rc_u[pos[cp]]
                if not bad_plain.any():
                    return self._validate_oracle()
                k = int(cp[int(bad_plain.argmax())])
                a = arr[int(bad_plain.argmax())]
                raise AssertionError(
                    f"{ts[k]}: departs before chunk arrived "
                    f"(arr={a if np.isfinite(a) else None})")

        # post-conditions: every destination reached (or holds from origin /
        # is the assembly root)
        pk, pd = [], []
        for ci, c in enumerate(conds):
            for d in c.dests:
                pk.append(ci)
                pd.append(d)
        pk = np.asarray(pk, np.int64)
        pd = np.asarray(pd, np.int64)
        cond_upos = np.searchsorted(uchunks, cchunk)
        got = pd == origin_u[cond_upos[pk]]
        if len(ukey):
            dkey = cond_upos[pk] * nn + pd
            dloc = np.minimum(np.searchsorted(ukey, dkey), len(ukey) - 1)
            got |= ukey[dloc] == dkey
        if not got.all():
            # an unreached dest of a reduced chunk may still hold the full
            # set outside the normal form (an interior forest node that
            # assembled it before forwarding) — defer those to the oracle;
            # a missing plain-chunk delivery is definite
            miss_plain = ~got & ~is_rc_u[cond_upos[pk]]
            if not miss_plain.any():
                return self._validate_oracle()
            k = int(miss_plain.argmax())
            raise AssertionError(
                f"chunk {conds[pk[k]].chunk} never reached NPU {pd[k]}")

    @staticmethod
    def _bulk_reduce_structure(conds, cidx, uchunks, is_rc_u, origin_u,
                               rel_u, pos, src, dst, start, end, red, nn):
        """Verify the in-forest normal form of the reduce transfers and
        return the effective (origin, release) per chunk for the copy-phase
        checks: per reduce chunk, its single assembly root and the time the
        full contribution set assembles there. Raises :class:`_NotInForest`
        when the schedule is outside the normal form — the caller then hands
        the verdict to the reference oracle."""
        su, sn = [], []
        for j, ci in enumerate(cidx):
            c = conds[ci]
            if type(c) is ReduceCondition:
                for s in c.srcs:
                    su.append(j)
                    sn.append(s)
        skey = np.asarray(su, np.int64) * nn + np.asarray(sn, np.int64)
        skey.sort()

        ridx = np.nonzero(red)[0]
        rpos, rsrc, rdst = pos[ridx], src[ridx], dst[ridx]
        rstart, rend = start[ridx], end[ridx]
        if len(ridx) and not is_rc_u[rpos].all():
            raise _NotInForest("reduce transfer on a non-reduction chunk")
        # each device forwards its accumulated partial at most once
        okey = rpos * nn + rsrc
        u_out, out_counts = np.unique(okey, return_counts=True)
        if (out_counts > 1).any():
            raise _NotInForest("a node forwards its partial twice")
        # latest merged-partial arrival per (chunk, node)
        ikey = rpos * nn + rdst
        u_in, inv_in = np.unique(ikey, return_inverse=True)
        in_max = np.full(len(u_in), -np.inf)
        np.maximum.at(in_max, inv_in, rend)
        if len(u_in):
            loc = np.minimum(np.searchsorted(u_in, okey), len(u_in) - 1)
            has_in = u_in[loc] == okey
            need = np.where(has_in, in_max[loc], -np.inf)
        else:
            has_in = np.zeros(len(okey), bool)
            need = np.full(len(okey), -np.inf)
        if (rstart < need - _EPS).any():
            raise _NotInForest("a partial forwards before every merged "
                               "contribution arrived")
        # senders that merged nothing must be declared contributors
        if len(skey):
            loc = np.minimum(np.searchsorted(skey, okey), len(skey) - 1)
            is_src_sender = skey[loc] == okey
        else:
            is_src_sender = np.zeros(len(okey), bool)
        if (~has_in & ~is_src_sender).any():
            raise _NotInForest("a reduce sender holds no contribution")
        # every participant (contributor or merge point) forwards except
        # exactly one root per chunk, where the full set assembles;
        # acyclicity comes from the arrival-before-forward check above
        pkeys = np.union1d(skey, u_in)
        if len(u_out):
            loc = np.minimum(np.searchsorted(u_out, pkeys), len(u_out) - 1)
            has_out = u_out[loc] == pkeys
        else:
            has_out = np.zeros(len(pkeys), bool)
        roots = pkeys[~has_out]
        root_upos = roots // nn
        counts = np.zeros(len(uchunks), np.int64)
        np.add.at(counts, root_upos, 1)
        if (is_rc_u & (counts != 1)).any():
            raise _NotInForest("contributions do not assemble at a single "
                               "root")
        root_node = np.full(len(uchunks), -1, np.int64)
        root_node[root_upos] = roots % nn
        assembled = rel_u.copy()
        if len(u_in):
            loc = np.minimum(np.searchsorted(u_in, roots), len(u_in) - 1)
            found = u_in[loc] == roots
            assembled[root_upos] = np.maximum(
                assembled[root_upos],
                np.where(found, in_max[loc], -np.inf))
        # copies of a reduced chunk originate at its root, post-assembly
        return (np.where(is_rc_u, root_node, origin_u),
                np.where(is_rc_u, assembled, rel_u))

    def _validate_oracle(self) -> None:
        topo = self.topology
        sizes = {c.chunk: c.bytes for c in self.conditions}
        releases = {c.chunk: c.release for c in self.conditions}

        # 1. Link-level checks: existence, duration, congestion-freedom.
        by_link: dict[int, list[Transfer]] = defaultdict(list)
        for t in self.transfers:
            link = topo.links[t.link]
            if (link.src, link.dst) != (t.src, t.dst):
                raise AssertionError(f"{t} does not ride link {link}")
            want = link.transfer_time(sizes[t.chunk])
            if abs((t.end - t.start) - want) > _EPS:
                raise AssertionError(
                    f"{t}: duration {t.end - t.start} != alpha-beta time {want}"
                )
            by_link[t.link].append(t)
        for link_id, ts in by_link.items():
            ts.sort(key=lambda t: t.start)
            for a, b in zip(ts, ts[1:]):
                if a.overlaps(b):
                    raise AssertionError(f"congestion on link {link_id}: {a} vs {b}")

        # 2. Replay: presence/causality/switch constraints/reduction algebra.
        # holdings[node][chunk] = frozenset of contributions (presence for
        # plain chunks is the singleton {src}).
        holdings: dict[int, dict[int, frozenset[int]]] = defaultdict(dict)
        sent_reduce: set[tuple[int, int]] = set()  # (node, chunk) partial already sent
        full_sets: dict[int, frozenset[int]] = {}
        for c in self.conditions:
            if isinstance(c, ReduceCondition):
                full_sets[c.chunk] = c.srcs
                for s in c.srcs:
                    holdings[s][c.chunk] = frozenset([s])
            else:
                full_sets[c.chunk] = frozenset([c.src])
                holdings[c.src][c.chunk] = frozenset([c.src])

        # switch occupancy / multicast bookkeeping:
        # residency of (switch, chunk) = [arrival end, last outgoing send end]
        switch_arrive: dict[tuple[int, int], float] = {}
        switch_depart: dict[tuple[int, int], float] = {}
        switch_sends: dict[int, list[Transfer]] = defaultdict(list)

        for t in self.transfers:
            held = holdings[t.src].get(t.chunk)
            if held is None:
                raise AssertionError(f"{t}: sender does not hold chunk")
            if t.start < releases[t.chunk] - _EPS:
                raise AssertionError(f"{t}: starts before chunk release")
            if t.reduce:
                if (t.src, t.chunk) in sent_reduce:
                    raise AssertionError(f"{t}: node sent its partial twice")
                sent_reduce.add((t.src, t.chunk))
                prev = holdings[t.dst].get(t.chunk, frozenset())
                if prev & held:
                    raise AssertionError(
                        f"{t}: double-counted contributions {sorted(prev & held)}"
                    )
                holdings[t.dst][t.chunk] = prev | held
                # The partial leaves the sender (it must not contribute again);
                # keep it recorded for causality of later copies only if it is
                # the full set (i.e. sender was the reduction root).
                if held != full_sets[t.chunk]:
                    del holdings[t.src][t.chunk]
            else:
                if full_sets[t.chunk] != held:
                    # copying a partially-reduced chunk is a correctness bug
                    if len(full_sets[t.chunk]) > 1:
                        raise AssertionError(
                            f"{t}: copies partial reduction {sorted(held)}"
                        )
                holdings[t.dst][t.chunk] = held
            if topo.is_switch(t.src):
                switch_sends[t.src].append(t)
                key = (t.src, t.chunk)
                switch_depart[key] = max(switch_depart.get(key, 0.0), t.end)
            if topo.is_switch(t.dst):
                key = (t.dst, t.chunk)
                if key not in switch_arrive:
                    switch_arrive[key] = t.end

        # 2b. causality in time: arrival must precede departure. Replay above
        # processed transfers in start order; verify explicitly with times.
        arrival: dict[tuple[int, int], float] = {}
        for c in self.conditions:
            if isinstance(c, ReduceCondition):
                for s in c.srcs:
                    arrival[(s, c.chunk)] = c.release
            else:
                arrival[(c.src, c.chunk)] = c.release
        for t in self.transfers:
            a = arrival.get((t.src, t.chunk))
            if a is None or t.start < a - _EPS:
                raise AssertionError(f"{t}: departs before chunk arrived (arr={a})")
            prev = arrival.get((t.dst, t.chunk), float("inf"))
            arrival[(t.dst, t.chunk)] = min(prev, t.end)

        # 3. Switch constraints.
        for sw, sends in switch_sends.items():
            node = topo.nodes[sw]
            if not node.multicast:
                # a non-multicast switch cannot duplicate one chunk onto
                # several egress ports at once (paper §4.7); distinct chunks
                # may still flow through different ports concurrently.
                per_chunk: dict[int, list[Transfer]] = defaultdict(list)
                for t in sends:
                    per_chunk[t.chunk].append(t)
                for chunk, ts in per_chunk.items():
                    ts.sort(key=lambda t: t.start)
                    for a, b in zip(ts, ts[1:]):
                        if a.overlaps(b):
                            raise AssertionError(
                                f"non-multicast switch {sw} duplicates chunk "
                                f"{chunk} concurrently: {a} / {b}"
                            )
        residency: dict[int, list[tuple[float, float]]] = defaultdict(list)
        for (sw, chunk), arr in switch_arrive.items():
            dep = switch_depart.get((sw, chunk), arr)
            residency[sw].append((arr, max(dep, arr)))
        for sw, intervals in residency.items():
            limit = topo.nodes[sw].buffer_limit
            if limit is None:
                continue
            events = []
            for a, d in intervals:
                events.append((a, +1))
                events.append((d, -1))
            occ = 0
            # departures (-1) release the slot before same-instant arrivals
            for _, delta in sorted(events, key=lambda e: (e[0], e[1])):
                occ += delta
                if occ > limit:
                    raise AssertionError(f"switch {sw} buffer exceeded ({occ} > {limit})")

        # 4. Post-conditions.
        for c in self.conditions:
            dests = c.dests
            for d in dests:
                got = holdings[d].get(c.chunk)
                if got is None:
                    raise AssertionError(f"chunk {c.chunk} never reached NPU {d}")
                if got != full_sets[c.chunk]:
                    raise AssertionError(
                        f"chunk {c.chunk} at NPU {d} has contributions "
                        f"{sorted(got)} != {sorted(full_sets[c.chunk])}"
                    )

    def is_valid(self) -> bool:
        try:
            self.validate()
            return True
        except AssertionError:
            return False
