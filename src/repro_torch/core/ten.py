"""Time-Expanded Network (paper §2.6, §4.2) — array-backed.

The TEN fuses spatial topology with time. The paper presents it as a boolean
matrix ``TEN[t][s][d]`` for unit-timestep (homogeneous) networks, generalized
to alpha-beta continuous times for heterogeneous ones (paper §4.6, Fig. 9-10).

One structure covers both modes:

* **Integer fast path** (homogeneous, uniform chunk size): per-link occupancy
  is a growable numpy bitmap ``_bits[num_links, horizon]`` — exactly the
  paper's boolean TEN with the (src, dst) axis collapsed onto physical link
  ids.  ``busy_row``/``free_mask`` expose whole-timestep occupancy slices for
  vectorized frontier expansion, and a per-link Python-int mirror
  (``_masks``) answers the scalar hot-loop queries — ``free_int`` and the
  next-free-slot search in :func:`repro.core.pathfinding.bfs_int` — in a few
  word operations (``(~m) & (m + 1)`` isolates the lowest free slot).
* **Continuous intervals** (heterogeneous, §4.6): every link carries sorted
  disjoint busy intervals; "removing TEN links" (paper Fig. 7/10) =
  committing a busy interval.

TENs are reusable: :meth:`reset` clears all occupancy in O(allocated) without
reallocating, so :class:`repro.core.engine.SynthesisEngine` keeps one TEN per
topology across collectives instead of constructing one per call.

Switches (paper §4.7) additionally carry residency intervals (chunks
buffered) used to enforce finite buffer limits during pathfinding.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np

from repro_torch.topology.topology import Topology

_EPS = 1e-9
_INITIAL_HORIZON = 64


class TEN:
    def __init__(self, topology: Topology):
        self.topology = topology
        # per-link sorted, disjoint busy intervals [(start, end), ...]
        self._busy: list[list[tuple[float, float]]] = [
            [] for _ in range(topology.num_links)
        ]
        # >>> copy fix: arrival floors for a chunk's whole stay
        # per-switch committed chunk-residency intervals
        self._residency: dict[int, list[tuple[float, float]]] = defaultdict(list)
        # per-switch earliest arrival of the chunk being searched: set by
        # path finding while it re-times a stay that would overfill a buffer
        self._floors: dict[int, float] = {}
        # <<< copy fix
        # integer fast path: [num_links, capacity] occupancy bitmap plus a
        # per-link int mirror (bit t set = timestep t busy) for scalar queries
        self._cap = _INITIAL_HORIZON
        self._bits = np.zeros((topology.num_links, self._cap), dtype=bool)
        self._masks: list[int] = [0] * topology.num_links
        # bit_length of each mask, mirrored so the pathfinding inner loop
        # replaces a method call with a list index
        self._mask_bl: list[int] = [0] * topology.num_links
        # latest committed busy end, maintained incrementally by commit/
        # commit_int so horizon() is O(1) instead of rescanning every link
        self._horizon: float = 0.0

    def reset(self) -> None:
        """Clear all committed occupancy, keeping allocations. Re-syncs with
        the topology if links were added since construction."""
        n = self.topology.num_links
        if n != len(self._masks):
            self._busy = [[] for _ in range(n)]
            self._bits = np.zeros((n, self._cap), dtype=bool)
        else:
            for iv in self._busy:
                iv.clear()
            self._bits[:] = False
        self._masks = [0] * n
        self._mask_bl = [0] * n
        self._residency.clear()
        self._horizon = 0.0

    # ------------------------------------------------------------------
    # Continuous (heterogeneous) interface — paper §4.6
    # ------------------------------------------------------------------
    def earliest_free(self, link: int, t: float, dur: float) -> float:
        """Earliest start >= t such that [start, start+dur) avoids busy slots."""
        intervals = self._busy[link]
        start = t
        i = bisect.bisect_left(intervals, (start - _EPS, float("-inf")))
        # also consider the interval just before, which may cover `start`
        if i > 0 and intervals[i - 1][1] > start + _EPS:
            start = intervals[i - 1][1]
        while i < len(intervals):
            s, e = intervals[i]
            if start + dur <= s + _EPS:
                return start
            start = max(start, e)
            i += 1
        return start

    def commit(self, link: int, start: float, end: float) -> None:
        intervals = self._busy[link]
        i = bisect.bisect_left(intervals, (start, end))
        if i > 0 and intervals[i - 1][1] > start + _EPS:
            raise AssertionError(f"link {link}: overlap committing [{start},{end})")
        if i < len(intervals) and intervals[i][0] < end - _EPS:
            raise AssertionError(f"link {link}: overlap committing [{start},{end})")
        intervals.insert(i, (start, end))
        if end > self._horizon:
            self._horizon = end

    # ------------------------------------------------------------------
    # Integer fast path (homogeneous, uniform chunk size) — paper §4.2
    # ------------------------------------------------------------------
    def free_int(self, link: int, t: int) -> bool:
        return not (self._masks[link] >> t) & 1

    def earliest_free_int(self, link: int, t: int) -> int:
        """First timestep >= t with the link free: lowest zero bit of the
        occupancy mask at or above t."""
        m = self._masks[link] >> t
        low_zero = ~m & (m + 1)
        return t + low_zero.bit_length() - 1

    def commit_int(self, link: int, t: int) -> None:
        if (self._masks[link] >> t) & 1:
            raise AssertionError(f"link {link}: timestep {t} already occupied")
        if t >= self._cap:
            self._grow(t)
        self._bits[link, t] = True
        m = self._masks[link] | (1 << t)
        self._masks[link] = m
        self._mask_bl[link] = m.bit_length()
        if t + 1 > self._horizon:
            self._horizon = float(t + 1)

    def commit_int_many(self, transfers) -> None:
        """Bulk ``commit_int`` for a pruned path's transfers (one call per
        condition instead of one per transfer)."""
        masks = self._masks
        mask_bl = self._mask_bl
        bits = self._bits
        hi = self._horizon
        for tr in transfers:
            link = tr.link
            t = int(tr.start)
            if (masks[link] >> t) & 1:
                raise AssertionError(
                    f"link {link}: timestep {t} already occupied"
                )
            if t >= self._cap:
                self._grow(t)
                bits = self._bits
            bits[link, t] = True
            m = masks[link] | (1 << t)
            masks[link] = m
            mask_bl[link] = m.bit_length()
            if t + 1 > hi:
                hi = float(t + 1)
        self._horizon = hi

    def commit_int_cols(self, links: np.ndarray, starts: np.ndarray) -> None:
        """Columnar bulk commit: one vectorized pass for a whole preloaded
        schedule (phase composition commits millions of transfers here).
        ``starts`` are float timestamps on integer boundaries."""
        if not len(links):
            return
        t = starts.astype(np.int64)
        tmax = int(t.max())
        if tmax >= self._cap:
            self._grow(tmax)
        if self._bits[links, t].any():
            k = int(np.nonzero(self._bits[links, t])[0][0])
            raise AssertionError(
                f"link {links[k]}: timestep {int(t[k])} already occupied")
        # duplicates inside the batch would silently collapse under fancy
        # assignment — detect them the same way a serial commit would
        key = links.astype(np.int64) * (self._cap + 1) + t
        if len(np.unique(key)) != len(key):
            dup = np.sort(key)
            k = int(np.nonzero(dup[1:] == dup[:-1])[0][0])
            raise AssertionError(
                f"link {int(dup[k] // (self._cap + 1))}: timestep "
                f"{int(dup[k] % (self._cap + 1))} already occupied")
        self._bits[links, t] = True
        # rebuild the scalar mirrors only for the touched links
        for link in np.unique(links).tolist():
            m = int.from_bytes(
                np.packbits(self._bits[link], bitorder="little").tobytes(),
                "little")
            self._masks[link] = m
            self._mask_bl[link] = m.bit_length()
        if tmax + 1 > self._horizon:
            self._horizon = float(tmax + 1)

    def _grow(self, t: int) -> None:
        new_cap = max(self._cap * 2, t + 1)
        bits = np.zeros((self.topology.num_links, new_cap), dtype=bool)
        bits[:, : self._cap] = self._bits
        self._bits = bits
        self._cap = new_cap

    # -- vectorized occupancy views -------------------------------------
    def busy_row(self, t: int) -> np.ndarray:
        """Occupancy of every link at timestep ``t`` (bool[num_links])."""
        if t >= self._cap:
            return np.zeros(self.topology.num_links, dtype=bool)
        return self._bits[:, t]

    def free_mask(self, links: np.ndarray, t: int) -> np.ndarray:
        """Per-link freedom at timestep ``t`` for an int array of link ids."""
        if t >= self._cap:
            return np.ones(len(links), dtype=bool)
        return ~self._bits[links, t]

    # ------------------------------------------------------------------
    # Switch residency (buffer limits) — paper §4.7
    # ------------------------------------------------------------------
    def occupancy_at(self, switch: int, t: float) -> int:
        return sum(1 for s, e in self._residency[switch] if s - _EPS <= t < e - _EPS)

    # >>> copy fix: a chunk's whole stay in a limited switch buffer
    # A chunk stays in a switch from its arrival to its last forward, and
    # validate() counts it there for all of that time. Path finding checks
    # room only on arrival, then re-times a stay that would overfill the
    # buffer later on (pathfinding._whole_stays) by raising the switch's
    # arrival floor, which the two queries below honour.
    def next_drop_after(self, switch: int, t: float) -> float:
        """Earliest residency end > t (inf if none); the switch's arrival
        floor while t is below it."""
        floor = self._floors.get(switch)
        if floor is not None and t < floor - _EPS:
            return floor
        ends = [e for _, e in self._residency[switch] if e > t + _EPS]
        return min(ends) if ends else float("inf")

    def buffer_has_room(self, switch: int, t: float) -> bool:
        limit = self.topology.nodes[switch].buffer_limit
        if limit is None:
            return True
        floor = self._floors.get(switch)
        if floor is not None and t < floor - _EPS:
            return False
        return self.occupancy_at(switch, t) < limit

    def stay_clash(self, switch: int, start: float, end: float) -> float | None:
        """The first instant of the stay [start, end) at which committed
        residencies already fill the switch's buffer, or None. Occupancy
        rises only where a residency starts, so those are the instants to
        check; a residency ending at an instant has left before it."""
        limit = self.topology.nodes[switch].buffer_limit
        if limit is None:
            return None
        res = self._residency.get(switch, ())
        points = sorted({s for s, _ in res if start + _EPS < s < end - _EPS})
        for t in [start, *points]:
            if self.occupancy_at(switch, t) >= limit:
                return t
        return None

    def next_room(self, switch: int, t: float) -> float:
        """The first instant >= t with room in the switch's buffer: finite,
        since every committed residency ends (inf for a buffer of none)."""
        while t != float("inf") and not self.buffer_has_room(switch, t):
            t = self.next_drop_after(switch, t)
        return t

    @staticmethod
    def switch_stays(topology, cols) -> dict:
        """{(limited switch, chunk): (arrival, departure)} of a finished
        schedule (``TransferColumns`` in schedule order), as validate()
        counts residencies: the first arrival's end to the last forward's
        end, over the whole schedule."""
        limited = set(topology.csr().limited_switches)
        arrive: dict[tuple[int, int], float] = {}
        depart: dict[tuple[int, int], float] = {}
        if limited:
            for c, u, v, e in zip(cols.chunk.tolist(), cols.src.tolist(),
                                  cols.dst.tolist(), cols.end.tolist()):
                if u in limited:
                    depart[(u, c)] = max(depart.get((u, c), 0.0), e)
                if v in limited:
                    arrive.setdefault((v, c), e)
        return {k: (a, max(depart.get(k, a), a)) for k, a in arrive.items()}

    def commit_stays(self, cols) -> None:
        """Commit the residencies a finished schedule leaves in the limited
        switches (``switch_stays``)."""
        for (sw, _), (a, d) in self.switch_stays(self.topology, cols).items():
            self.commit_residency(sw, a, d)

    def commit_residency(self, switch: int, start: float, end: float) -> None:
        self._residency[switch].append((start, max(end, start)))
    # <<< copy fix

    # ------------------------------------------------------------------
    def horizon(self) -> float:
        """Latest committed busy end (safety bound for searches). Tracked
        incrementally at commit time — called once per BFS, so rescanning
        every link's intervals here was O(links) per pathfinding call."""
        return self._horizon
