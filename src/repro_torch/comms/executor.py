"""Execute PCCL-synthesized schedules as rounds of point-to-point sends.

The port of ``repro/comms/executor.py``. A translated program
(``core.translate.PpermuteProgram``) is a list of rounds; in each round
every device sends at most one chunk and receives at most one. A static
*buffer plan* gives every device a slot for every chunk it ever holds
(source, forwarder -- possibly outside the process group, which is how
process-group awareness executes -- or destination), plus one trash slot.
The plan is numpy and equals the reference's table for table.

A round, on every device: send ``buf[send_slot]``; at ``recv_slot`` add the
received chunk if the send is a reduction, else overwrite the slot with it;
a device that receives nothing writes zeros to its trash slot. Two backends
run it:

- ``StackedBackend``: every rank's buffer in one tensor
  ``[num_devices, buffer_slots, *chunk]`` on one device (the card, or the
  CPU when the caller puts the tensor there). A round is one gather of the
  sent chunks and one write of the received ones.
- ``DistBackend``: one rank per process through ``torch.distributed``, one
  ``batch_isend_irecv`` a round. NCCL for CUDA tensors, gloo for CPU
  tensors; it never switches from one to the other.

``interpret_rounds`` is the same semantics in numpy, the oracle both
backends are held to.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.translate import PpermuteProgram


@dataclass
class RoundTables:
    perm: list[tuple[int, int]]
    send_slot: np.ndarray  # [num_devices] slot each device sends (0 if none)
    recv_slot: np.ndarray  # [num_devices] slot each device writes (trash if none)
    is_recv: np.ndarray  # [num_devices] bool
    is_reduce: np.ndarray  # [num_devices] bool (receive-reduce vs receive-copy)


@dataclass
class BufferPlan:
    num_devices: int
    num_slots: int  # data slots; slot num_slots is the trash slot
    slot_of: dict[tuple[int, int], int]  # (device, chunk) -> slot
    rounds: list[RoundTables] = field(default_factory=list)
    # per-device tensors built from the tables, keyed by (what, device); torch
    # has no tracers, so one copy per device can be shared by every call
    _cache: dict = field(default_factory=dict, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    @property
    def buffer_slots(self) -> int:
        return self.num_slots + 1  # + trash

    def cached(self, key, build):
        """``build()`` once per key, under the plan's lock."""
        with self._lock:
            if key not in self._cache:
                self._cache[key] = build()
            return self._cache[key]

    def round_tables(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(send_slot, recv_slot, is_reduce) stacked over rounds,
        ``[num_rounds, num_devices]`` int64 / int64 / bool tensors on
        ``device``, built once per device."""
        device = torch.device(device)

        def build():
            n = self.num_devices
            if self.rounds:
                send = np.stack([rt.send_slot for rt in self.rounds])
                recv = np.stack([rt.recv_slot for rt in self.rounds])
                red = np.stack([rt.is_reduce for rt in self.rounds])
            else:
                send = np.zeros((0, n), np.int64)
                recv = np.zeros((0, n), np.int64)
                red = np.zeros((0, n), bool)
            return (torch.as_tensor(send.astype(np.int64), device=device),
                    torch.as_tensor(recv.astype(np.int64), device=device),
                    torch.as_tensor(red, device=device))

        return self.cached(("round_tables", device), build)

    def slot_table(self, chunks: list[int]) -> np.ndarray:
        """``[num_devices, len(chunks)]`` slot of each chunk on each device;
        a chunk a device never holds maps to the trash slot."""
        t = np.full((self.num_devices, len(chunks)), self.num_slots, np.int64)
        for j, chunk in enumerate(chunks):
            for dev in range(self.num_devices):
                got = self.slot_of.get((dev, chunk))
                if got is not None:
                    t[dev, j] = got
        return t


def plan_buffers(prog: PpermuteProgram) -> BufferPlan:
    """Assign per-device buffer slots and build per-round permute tables.

    Array-backed: slots live in a dense ``[num_devices, num_chunks]`` int32
    matrix (-1 = unassigned) and every round's tables are filled with numpy
    scatters over the round's send arrays. Slot numbering: initial holders
    first (condition order), then receivers in round order -- each device
    appears at most once as a destination per round, so the vectorized
    assignment order cannot collide. ``slot_of`` is materialized once at the
    end for the primitives' lookup API.
    """
    n = prog.num_devices
    chunks = sorted(prog.chunk_holders)
    cidx = {c: k for k, c in enumerate(chunks)}
    slot = np.full((n, len(chunks)), -1, dtype=np.int32)
    next_slot = np.zeros(n, dtype=np.int32)

    # initial holders (sources; every contributor for reduced chunks)
    for chunk, holders in prog.chunk_holders.items():
        k = cidx[chunk]
        for h in holders:
            if slot[h, k] < 0:
                slot[h, k] = next_slot[h]
                next_slot[h] += 1

    rounds: list[RoundTables] = []
    for sends in prog.rounds:
        send_slot = np.zeros(n, dtype=np.int32)
        recv_slot = np.zeros(n, dtype=np.int32)
        is_recv = np.zeros(n, dtype=bool)
        is_reduce = np.zeros(n, dtype=bool)
        if not sends:
            rounds.append(RoundTables([], send_slot, recv_slot, is_recv,
                                      is_reduce))
            continue
        m = len(sends)
        src = np.fromiter((s.src for s in sends), np.int64, m)
        dst = np.fromiter((s.dst for s in sends), np.int64, m)
        red = np.fromiter((s.reduce for s in sends), bool, m)
        try:
            ck = np.fromiter((cidx[s.chunk] for s in sends), np.int64, m)
        except KeyError:
            bad = next(s for s in sends if s.chunk not in cidx)
            raise AssertionError(
                f"send of chunk {bad.chunk} from device {bad.src} "
                f"before arrival"
            ) from None
        ssl = slot[src, ck]
        if (ssl < 0).any():
            bad = sends[int(np.argmax(ssl < 0))]
            raise AssertionError(
                f"send of chunk {bad.chunk} from device {bad.src} "
                f"before arrival"
            )
        need = slot[dst, ck] < 0
        # destinations are unique within a round, so the scattered slot
        # grants cannot collide
        slot[dst[need], ck[need]] = next_slot[dst[need]]
        next_slot[dst[need]] += 1
        send_slot[src] = ssl
        recv_slot[dst] = slot[dst, ck]
        is_recv[dst] = True
        is_reduce[dst] = red
        perm = list(zip(src.tolist(), dst.tolist()))
        rounds.append(RoundTables(perm, send_slot, recv_slot, is_recv,
                                  is_reduce))

    num_slots = int(next_slot.max()) if n else 0
    devs, ks = np.nonzero(slot >= 0)
    slot_of = {
        (int(d), chunks[k]): int(slot[d, k]) for d, k in zip(devs, ks)
    }
    plan = BufferPlan(n, num_slots, slot_of, rounds)
    # route non-receivers' zeros into the trash slot
    for rt in plan.rounds:
        rt.recv_slot = np.where(rt.is_recv, rt.recv_slot, num_slots).astype(np.int32)
    return plan


# ---------------------------------------------------------------------------
# Plan cache: (fingerprint, program digest) -> BufferPlan. Repeated identical
# collectives (the all-reduce issued every training step) skip plan_buffers
# and share the plan's per-device tables.
# ---------------------------------------------------------------------------

_PLAN_CACHE: OrderedDict[object, BufferPlan] = OrderedDict()
_PLAN_CACHE_MAX = 128
_PLAN_LOCK = threading.Lock()
plan_cache_stats = {"hits": 0, "misses": 0}


def plan_buffers_cached(prog: PpermuteProgram, fingerprint: object) -> BufferPlan:
    """``plan_buffers`` behind a thread-safe LRU.

    The key pairs the caller's fingerprint with the program's own structural
    digest, so two distinct programs whose callers hand in the same
    fingerprint never share one buffer plan.
    """
    key = (fingerprint, prog.digest())
    with _PLAN_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _PLAN_CACHE.move_to_end(key)
            plan_cache_stats["hits"] += 1
            return plan
    # plan outside the lock: duplicated work under a race is cheaper than
    # serializing every cold plan behind one mutex
    plan = plan_buffers(prog)
    with _PLAN_LOCK:
        existing = _PLAN_CACHE.get(key)
        if existing is not None:
            _PLAN_CACHE.move_to_end(key)
            plan_cache_stats["hits"] += 1
            return existing
        plan_cache_stats["misses"] += 1
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return plan


def clear_plan_cache() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        plan_cache_stats.update(hits=0, misses=0)


# ---------------------------------------------------------------------------
# the round semantics in numpy
# ---------------------------------------------------------------------------

def interpret_rounds(plan: BufferPlan, buf: np.ndarray) -> np.ndarray:
    """Run every round on a stacked numpy buffer
    ``[num_devices, buffer_slots, *chunk]`` in place and return it: each
    device sends ``buf[send_slot]``; non-receivers get zeros; the received
    value lands at ``recv_slot`` (the trash slot for non-receivers), added
    when ``is_reduce`` else overwriting."""
    dev = np.arange(plan.num_devices)
    for rt in plan.rounds:
        sent = buf[dev, rt.send_slot]
        got = np.zeros_like(sent)
        for s, d in rt.perm:
            got[d] = sent[s]
        old = buf[dev, rt.recv_slot]
        red = rt.is_reduce.reshape((-1,) + (1,) * (buf.ndim - 2))
        buf[dev, rt.recv_slot] = np.where(red, old + got, got)
    return buf


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class StackedBackend:
    """Every rank's buffer in one tensor ``[num_devices, buffer_slots,
    *chunk]``; runs on the tensor's device. Per-rank tables apply to all
    ranks at once."""

    rank = None  # every rank

    def rows(self, table: np.ndarray, device) -> torch.Tensor:
        """A per-device table ``[num_devices, ...]`` as a tensor, all rows."""
        return torch.as_tensor(table, device=device)

    def _schedule(self, plan: BufferPlan, device):
        """Per round, index tensors into the ``[num_devices * buffer_slots,
        *chunk]`` view: the slots sent to receive-copy destinations and
        those destinations, the same for receive-reduce destinations, and
        the non-receivers' trash slots (None where a list is empty). Built
        once per device."""
        def build():
            nb = plan.buffer_slots
            out = []
            for rt in plan.rounds:
                src, dst = (np.asarray(a, np.int64).reshape(-1)
                            for a in (zip(*rt.perm) if rt.perm else ((), ())))
                sent = src * nb + rt.send_slot[src]
                recv = dst * nb + rt.recv_slot[dst]
                red = rt.is_reduce[dst]
                trash = np.flatnonzero(~rt.is_recv) * nb + plan.num_slots

                def t(a):
                    return torch.as_tensor(a.astype(np.int64), device=device) \
                        if len(a) else None
                out.append((t(sent[~red]), t(recv[~red]), t(sent[red]),
                            t(recv[red]), t(trash)))
            return out

        return plan.cached(("stacked_schedule", torch.device(device)), build)

    def execute(self, plan: BufferPlan, buf: torch.Tensor) -> torch.Tensor:
        if buf.shape[:2] != (plan.num_devices, plan.buffer_slots):
            raise ValueError(f"stacked buffer {tuple(buf.shape)}: want "
                             f"[{plan.num_devices}, {plan.buffer_slots}, *chunk]")
        if not buf.is_contiguous():
            raise ValueError("the stacked buffer must be contiguous")
        flat = buf.view(plan.num_devices * plan.buffer_slots, *buf.shape[2:])
        for cp_src, cp_dst, red_src, red_dst, trash in self._schedule(plan, buf.device):
            # every sent chunk is read before any slot of the round is written
            cp = None if cp_src is None else flat.index_select(0, cp_src)
            red = None if red_src is None else flat.index_select(0, red_src)
            if cp is not None:
                flat.index_copy_(0, cp_dst, cp)
            if red is not None:
                flat.index_add_(0, red_dst, red)
            if trash is not None:
                flat.index_fill_(0, trash, 0)
        return buf

    def gather(self, buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``[num_devices, k, *chunk]``: slot ``idx[d, j]`` of device d."""
        dev = torch.arange(buf.shape[0], device=buf.device)[:, None]
        return buf[dev, idx]

    def put(self, buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
        """Write ``vals[:, j]`` to slot ``idx[d, j]`` of each device d,
        column by column (a later column wins where two name one slot)."""
        dev = torch.arange(buf.shape[0], device=buf.device)
        for j in range(idx.shape[1]):
            buf[dev, idx[:, j]] = vals[:, j]


class DistBackend:
    """One rank per process: the local buffer is ``[buffer_slots, *chunk]``
    and rank r of ``group`` is device r of the program. One
    ``batch_isend_irecv`` a round among the ranks that send or receive in
    it. The group's backend must match the buffer: NCCL for CUDA tensors,
    gloo for CPU tensors."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistBackend needs torch.distributed to be initialized")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._joined = False

    def rows(self, table: np.ndarray, device) -> torch.Tensor:
        return torch.as_tensor(table[self.rank], device=device)

    def _check(self, plan: BufferPlan, buf: torch.Tensor) -> None:
        import torch.distributed as dist

        if plan.num_devices != self.world:
            raise ValueError(f"the program has {plan.num_devices} devices, the "
                             f"group {self.world} ranks")
        want = "nccl" if buf.is_cuda else "gloo"
        have = dist.get_backend(self.group)
        if have != want:
            raise ValueError(f"a {buf.device.type} buffer needs a {want} group, "
                             f"this one is {have}")
        if not self._joined:
            # NCCL needs every rank of the group in the group's first P2P
            # call, but a round holds only its senders and receivers. So the
            # group's first use here is a barrier, which every rank joins
            # (each rank runs every collective, whether it is in the process
            # group or not).
            dist.barrier(group=self.group)
            self._joined = True

    def execute(self, plan: BufferPlan, buf: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if buf.shape[0] != plan.buffer_slots:
            raise ValueError(f"local buffer {tuple(buf.shape)}: want "
                             f"[{plan.buffer_slots}, *chunk]")
        self._check(plan, buf)
        me = self.rank
        peer = (lambda r: dist.get_global_rank(self.group, r)) if self.group else (lambda r: r)
        for rt in plan.rounds:
            ops, got = [], None
            for s, d in rt.perm:
                if s == me:
                    ops.append(dist.P2POp(dist.isend, buf[int(rt.send_slot[me])],
                                          peer(d), self.group))
                if d == me:
                    got = torch.empty_like(buf[0])
                    ops.append(dist.P2POp(dist.irecv, got, peer(s), self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            slot = int(rt.recv_slot[me])
            if got is None:
                buf[slot].zero_()
            elif rt.is_reduce[me]:
                buf[slot] += got
            else:
                buf[slot].copy_(got)
        return buf

    def gather(self, buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``[k, *chunk]``: slot ``idx[j]`` of this rank's buffer."""
        return buf[idx]

    def put(self, buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
        """Write ``vals[j]`` to slot ``idx[j]``, in j order."""
        for j in range(idx.shape[0]):
            buf[idx[j]] = vals[j]


STACKED = StackedBackend()


def execute_program(plan: BufferPlan, buf: torch.Tensor,
                    backend: StackedBackend | DistBackend = STACKED) -> torch.Tensor:
    """Run every round of ``plan`` on ``buf`` in place and return it.
    Stacked: ``buf`` is ``[num_devices, buffer_slots, *chunk]``; dist: this
    rank's ``[buffer_slots, *chunk]``. Source chunks are pre-placed at their
    planned slots; callers extract destination slots via ``plan.slot_of``."""
    return backend.execute(plan, buf)


def gather_slots(plan: BufferPlan, buf: torch.Tensor, chunks: list[int],
                 backend: StackedBackend | DistBackend = STACKED) -> torch.Tensor:
    """Extract ``chunks`` (in order) from the buffer: ``[num_devices,
    len(chunks), *chunk]`` stacked, ``[len(chunks), *chunk]`` on one rank.
    Missing chunks map to the trash slot."""
    return backend.gather(buf, backend.rows(plan.slot_table(chunks), buf.device))
