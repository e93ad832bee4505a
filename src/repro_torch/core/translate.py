"""Translate synthesis results into executable representations (paper §4.8).

The paper exports to MSCCL / MSCCL++ for GPU execution. Our deployment
substrate is JAX on TPU, so the primary translation is a *ppermute program*:
the timed transfer schedule is bucketed into rounds; each round becomes one
(or more) ``jax.lax.ppermute`` calls inside ``shard_map`` (see
``repro.comms.executor``). A congestion-free PCCL schedule whose transfers
ride physical-neighbor links translates to neighbor-only permutes on the TPU
torus, preserving the synthesizer's no-contention invariant.

An MSCCL-IR-style JSON export is retained for interoperability/debugging.
"""

from __future__ import annotations

import hashlib
import json
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.algorithm import CollectiveAlgorithm, TransferColumns
from repro_torch.core.conditions import Condition, ReduceCondition


@dataclass(frozen=True)
class Send:
    src: int
    dst: int
    chunk: int
    reduce: bool = False


@dataclass
class PpermuteProgram:
    """A list of rounds; each round is a set of sends where every device
    appears at most once as a source and at most once as a destination —
    i.e. each round is directly one ``lax.ppermute`` permutation."""

    num_devices: int
    rounds: list[list[Send]] = field(default_factory=list)
    # chunk -> condition metadata for buffer planning. Plain chunks have one
    # initial holder; reduced chunks start at every contributing device.
    chunk_holders: dict[int, tuple[int, ...]] = field(default_factory=dict)
    chunk_dests: dict[int, tuple[int, ...]] = field(default_factory=dict)
    _digest: str | None = field(default=None, repr=False, compare=False)

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def num_sends(self) -> int:
        return sum(len(r) for r in self.rounds)

    @property
    def chunk_srcs(self) -> dict[int, int]:
        """Primary holder per chunk (the source for non-reduction chunks)."""
        return {c: h[0] for c, h in self.chunk_holders.items()}

    def digest(self) -> str:
        """Structural fingerprint of the *program itself* (rounds, sends,
        chunk metadata), memoized. Buffer-plan caching keys on this in
        addition to the caller's fingerprint, so two distinct programs can
        never cross-serve one plan even if their callers' fingerprints
        collide (see ``repro.comms.executor.plan_buffers_cached``)."""
        if self._digest is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(str(self.num_devices).encode())
            for rnd in self.rounds:
                h.update(b"|")
                for s in rnd:
                    h.update(
                        f"{s.src},{s.dst},{s.chunk},{int(s.reduce)};".encode())
            h.update(repr(sorted(self.chunk_holders.items())).encode())
            h.update(repr(sorted(self.chunk_dests.items())).encode())
            self._digest = h.hexdigest()
        return self._digest


def _unroll_switch_hops(alg: CollectiveAlgorithm) -> list[tuple]:
    """Collapse switch hops into direct NPU-to-NPU sends.

    Switch nodes exist on the fabric (DCI/spine/aggregation) but not on the
    execution mesh, so a chunk's path ``npu -> switch -> ... -> npu`` must
    lower to sends between NPUs only. Walking transfers in time order, each
    switch keeps a per-chunk set of *contributions* — the effective NPU
    origins whose values have arrived so far:

    * a **copy** out of a switch (multicast fan-out, store-and-forward
      relay) re-emits from any arrived origin — every copy of a chunk
      carries the same value (the validator's normal form permits copies of
      reduce chunks only after assembly), so the origin choice is free and
      we take the earliest arrival for determinism; contributions stay for
      later fan-out hops;
    * a **reduce** out of a switch merges every arrived contribution — the
      lowered program sends each contributing origin's partial directly to
      the hop's destination, which accumulates them (receive-reduce), so
      the switch-side accumulation of the timed schedule is reproduced at
      the destination NPU. Contributions are consumed: the normal form
      allows at most one partial send per (chunk, node).

    Each lowered send is stamped with the *final hop's* start time, so wave
    order (and therefore store-and-forward causality) is inherited from the
    timed schedule: the origin held its value no later than its own send
    into the switch chain, which started strictly earlier.
    """
    topo = alg.topology
    is_sw = topo.is_switch
    # (switch, chunk) -> list of (arrival_time, origin_npu)
    pending: dict[tuple[int, int], list[tuple[float, int]]] = defaultdict(list)
    out: list[tuple] = []
    order = sorted(alg.transfers,
                   key=lambda t: (t.start, t.end, t.src, t.dst, t.chunk))
    eps = 1e-9
    for t in order:
        if is_sw(t.src):
            key = (t.src, t.chunk)
            arrived = [e for e in pending[key] if e[0] <= t.start + eps]
            if not arrived:
                raise ValueError(
                    f"switch {t.src} forwards chunk {t.chunk} at t={t.start} "
                    f"before any arrival: schedule is not store-and-forward"
                )
            if t.reduce:
                origins = [o for _, o in arrived]
                pending[key] = [e for e in pending[key]
                                if e[0] > t.start + eps]
            else:
                origins = [min(arrived)[1]]
        else:
            origins = [t.src]
        if is_sw(t.dst):
            pending[(t.dst, t.chunk)].extend((t.end, o) for o in origins)
        else:
            for o in origins:
                if o == t.dst:
                    if t.reduce:
                        raise ValueError(
                            f"chunk {t.chunk}: reduce contribution of NPU "
                            f"{o} routed back into itself (would double-"
                            f"count); schedule violates the in-forest form"
                        )
                    continue  # copy round-trip: value already resident
                out.append((t.start, o, t.dst, t.chunk, t.reduce))
    return out


def to_ppermute_program(
    alg: CollectiveAlgorithm,
    device_of_npu: dict[int, int] | None = None,
    *,
    unroll_switches: bool = True,
) -> PpermuteProgram:
    """Bucket timed transfers into dependency-honoring ppermute rounds.

    Transfers are grouped by start time (identical start = same wave of the
    synchronous schedule); each wave is split greedily so that within one
    round every device sends at most one chunk and receives at most one chunk
    (ppermute semantics). Store-and-forward causality is kept because waves
    execute in start-time order and a chunk's forward always starts at or
    after its arrival wave.

    Composed :class:`~repro.core.engine.PhasePlan` schedules (hierarchical
    sequential, chunk-pipelined, TE-routed, time-reversed, repaired) lower
    through the same path: their phases share one absolute clock, so
    per-chunk release floors and phase barriers collapse to wave order here,
    and their receive-reduce transfers carry the ``reduce`` flag per send.
    Schedules riding switch nodes (multi_pod DCI, three_level aggregation,
    two_level_switch spines) are unrolled into direct NPU-to-NPU sends
    first (see :func:`_unroll_switch_hops`); pass ``unroll_switches=False``
    to get the historical strict behavior instead.
    """
    if device_of_npu is None:
        device_of_npu = {n: n for n in alg.topology.npus}
    topo = alg.topology
    has_switch = any(
        topo.is_switch(int(n))
        for n in np.unique(np.concatenate(
            [alg.columns.src, alg.columns.dst]))
    ) if len(alg.columns) else False
    if has_switch:
        if not unroll_switches:
            raise ValueError(
                "ppermute translation requires NPU-to-NPU schedules; "
                "unroll switches or use the JSON export"
            )
        sends = _unroll_switch_hops(alg)
    else:
        cols = alg.columns
        sends = list(zip(cols.start.tolist(), cols.src.tolist(),
                         cols.dst.tolist(), cols.chunk.tolist(),
                         cols.reduce.tolist()))
    waves: dict[float, list[tuple]] = defaultdict(list)
    for s in sends:
        waves[round(s[0], 9)].append(s)

    prog = PpermuteProgram(num_devices=len(device_of_npu))
    for c in alg.conditions:
        holders = c.srcs if hasattr(c, "srcs") else (c.src,)
        prog.chunk_holders[c.chunk] = tuple(
            sorted(device_of_npu[s] for s in holders)
        )
        prog.chunk_dests[c.chunk] = tuple(
            sorted(device_of_npu[d] for d in c.dests)
        )
    for start in sorted(waves):
        pending = sorted(waves[start], key=lambda s: (s[1], s[2], s[3]))
        while pending:
            used_src: set[int] = set()
            used_dst: set[int] = set()
            round_sends: list[Send] = []
            rest: list[tuple] = []
            for t in pending:
                s, d = device_of_npu[t[1]], device_of_npu[t[2]]
                if s in used_src or d in used_dst:
                    rest.append(t)
                    continue
                used_src.add(s)
                used_dst.add(d)
                round_sends.append(Send(s, d, t[3], bool(t[4])))
            prog.rounds.append(round_sends)
            pending = rest
    return prog


def to_msccl_json(alg: CollectiveAlgorithm) -> str:
    """MSCCL-IR-flavored JSON: per-NPU ordered op lists with explicit
    dependencies implied by transfer times. The ``conditions`` section (an
    additive extension to the IR) records the pre/postconditions so the
    document round-trips through :func:`from_msccl_json` — this is the
    on-disk format of the algorithm registry."""
    ops_by_npu: dict[int, list[dict]] = defaultdict(list)
    # one tolist() per column: native scalars without per-row Transfer views
    cols = alg.columns
    rows = zip(cols.chunk.tolist(), cols.link.tolist(), cols.src.tolist(),
               cols.dst.tolist(), cols.start.tolist(), cols.end.tolist(),
               cols.reduce.tolist())
    for i, (chunk, link, src, dst, start, end, red) in enumerate(rows):
        ops_by_npu[src].append(
            {"op": "send", "chunk": chunk, "peer": dst, "t_start": start,
             "t_end": end, "link": link, "idx": i, "reduce": red}
        )
        kind = "recv_reduce" if red else "recv"
        ops_by_npu[dst].append(
            {"op": kind, "chunk": chunk, "peer": src, "t_start": start,
             "t_end": end, "link": link, "idx": i, "reduce": red}
        )
    conditions = []
    for c in alg.conditions:
        entry = {"chunk": c.chunk, "dests": sorted(c.dests), "bytes": c.bytes,
                 "release": c.release, "tag": c.tag}
        if isinstance(c, ReduceCondition):
            entry["srcs"] = sorted(c.srcs)
        else:
            entry["src"] = c.src
        conditions.append(entry)
    doc = {
        "name": alg.name,
        "topology": alg.topology.name,
        "num_npus": len(alg.topology.npus),
        "makespan": alg.makespan,
        "conditions": conditions,
        "gpus": [
            {"id": npu, "ops": sorted(ops, key=lambda o: (o["t_start"], o["idx"]))}
            for npu, ops in sorted(ops_by_npu.items())
        ],
    }
    return json.dumps(doc, indent=1)


def from_msccl_json(doc: str | dict, topology) -> CollectiveAlgorithm:
    """Inverse of :func:`to_msccl_json`: rebuild a ``CollectiveAlgorithm``
    against ``topology`` (which must be the fabric the document was exported
    from — link ids are positional). Raises ``ValueError`` on documents
    missing the ``conditions`` extension or referencing unknown links."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    if "conditions" not in doc:
        raise ValueError("document lacks the 'conditions' section; "
                         "re-export with to_msccl_json")
    conds: list = []
    for e in doc["conditions"]:
        if "srcs" in e:
            conds.append(ReduceCondition(
                e["chunk"], frozenset(e["srcs"]), frozenset(e["dests"]),
                e.get("bytes", 1.0), e.get("release", 0.0), e.get("tag", "")))
        else:
            conds.append(Condition(
                e["chunk"], e["src"], frozenset(e["dests"]),
                e.get("bytes", 1.0), e.get("release", 0.0), e.get("tag", "")))
    reduce_idx = {
        op["idx"] for gpu in doc["gpus"] for op in gpu["ops"]
        if op["op"] == "recv_reduce"
    }
    # gather send ops into parallel lists, then validate link ids and
    # endpoints in two vectorized sweeps instead of per-op topology lookups
    chunk: list[int] = []
    link: list[int] = []
    src: list[int] = []
    dst: list[int] = []
    start: list[float] = []
    end: list[float] = []
    red: list[bool] = []
    for gpu in doc["gpus"]:
        gid = gpu["id"]
        for op in gpu["ops"]:
            if op["op"] != "send":
                continue
            chunk.append(op["chunk"])
            link.append(op["link"])
            src.append(gid)
            dst.append(op["peer"])
            start.append(op["t_start"])
            end.append(op["t_end"])
            red.append(op.get("reduce", op["idx"] in reduce_idx))
    la = np.asarray(link, np.int64)
    sa = np.asarray(src, np.int64)
    da = np.asarray(dst, np.int64)
    nl = topology.num_links
    out_of_range = (la < 0) | (la >= nl)
    safe = np.where(out_of_range, 0, la)
    lsrc = np.fromiter((l.src for l in topology.links), np.int64, nl)
    ldst = np.fromiter((l.dst for l in topology.links), np.int64, nl)
    mismatch = ~out_of_range & ((lsrc[safe] != sa) | (ldst[safe] != da)) \
        if nl else out_of_range & False
    bad = out_of_range | mismatch
    if bad.any():
        # report the first offending op, matching the serial scan's order
        k = int(np.argmax(bad))
        if out_of_range[k]:
            raise ValueError(f"op references unknown link {link[k]}")
        raise ValueError(
            f"link {link[k]} endpoints do not match op "
            f"{src[k]}->{dst[k]}: topology mismatch")
    cols = TransferColumns(
        np.asarray(chunk, np.int64), la.astype(np.int32),
        sa.astype(np.int32), da.astype(np.int32),
        np.asarray(start, np.float64), np.asarray(end, np.float64),
        np.asarray(red, np.bool_))
    return CollectiveAlgorithm(topology, conds, cols,
                               name=doc.get("name", "pccl"))
