"""PCCL-backed collective primitives for PyTorch tensors.

The port of ``repro/comms/primitives.py``. Each collective runs a
PCCL-synthesized, topology-aware schedule as rounds of point-to-point sends
(``executor``) instead of a library collective. The schedule is synthesized
once per (topology, request, device mapping) and cached at every layer.

Every collective takes ``backend=``:

- the stacked backend (the default): ``x`` holds every rank's input stacked
  on a leading axis of ``num_devices``, and so does the result; it runs on
  ``x``'s device;
- a ``DistBackend``: ``x`` is this rank's input, as inside the reference's
  ``shard_map``, and the result is this rank's output.

Devices outside the process group may forward traffic for it (that is
process-group awareness executing) but return exact zeros.
``interpret_collective`` runs the same collective in numpy on a stacked
input: the oracle the card's results are held to bit for bit.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.comms.executor import (
    STACKED,
    BufferPlan,
    DistBackend,
    StackedBackend,
    execute_program,
    interpret_rounds,
    plan_buffers_cached,
)
from repro_torch.core.engine import SynthesisEngine
from repro_torch.core.registry import default_registry, topology_fingerprint
from repro_torch.core.request import CollectiveRequest
from repro_torch.core.translate import PpermuteProgram, to_ppermute_program
from repro_torch.topology.topology import Topology


@dataclass(frozen=True)
class CollectiveSpec:
    """What to synthesize: collective kind over a device group embedded in a
    physical topology. `device_of_npu` maps topology NPU ids to devices
    (ranks); it must cover every NPU that may forward traffic (the whole
    topology for process-group-aware routing).

    Everywhere a ``CollectiveSpec`` is accepted, a fully-specified
    :class:`~repro_torch.core.request.CollectiveRequest` works too -- that
    is the way to execute hierarchy/TE/pipelining-routed plans, since the
    request carries ``hierarchy``/``gateway_strategy``/``sketch``/``pipelined``."""

    kind: str  # all_gather | reduce_scatter | all_reduce | all_to_all
    group: tuple[int, ...]  # NPU ids of the process group, in rank order


_EXEC_KINDS = ("all_gather", "all_to_all", "reduce_scatter", "all_reduce")


def _as_request(spec, nbytes: float, pipelined_ar: bool) -> CollectiveRequest:
    """Normalize CollectiveSpec | CollectiveRequest into a CollectiveRequest."""
    if isinstance(spec, CollectiveRequest):
        req = spec
    elif isinstance(spec, CollectiveSpec):
        req = CollectiveRequest(
            spec.kind, group=tuple(spec.group), bytes=nbytes,
            pipelined=pipelined_ar if spec.kind == "all_reduce" else False)
    else:
        raise TypeError(
            f"spec must be CollectiveSpec or CollectiveRequest, "
            f"got {type(spec).__name__}")
    if req.kind not in _EXEC_KINDS:
        raise ValueError(
            f"collective kind {req.kind!r} is not executable "
            f"(expected one of {_EXEC_KINDS})")
    if not req.group:
        raise ValueError("executable collectives need an explicit group")
    return req


# translated programs, keyed by fingerprint (bounded LRU; BufferPlans are
# owned by the executor's plan cache, not pinned here)
_PROGRAM_CACHE: OrderedDict = OrderedDict()
_PROGRAM_CACHE_MAX = 128


def _engine_for(topo: Topology, registry) -> SynthesisEngine:
    """One engine per (topology, registry), attached to the topology object
    so distance caches persist across collectives, the whole bundle is
    garbage-collected with the topology, and graph mutation invalidates it."""
    engines = getattr(topo, "_pccl_engines", None)
    if engines is None:
        engines = topo._pccl_engines = OrderedDict()
    eng = engines.get(id(registry))
    if eng is None:
        # id(registry) stays valid while the entry exists because the engine
        # references the registry strongly
        eng = SynthesisEngine(topo, registry=registry)
        engines[id(registry)] = eng
        while len(engines) > 8:
            engines.popitem(last=False)
    return eng


def synthesize_program(
    topo: Topology,
    spec,
    *,
    nbytes: float = 1.0,
    device_of_npu: dict[int, int] | None = None,
    pipelined_ar: bool = True,
    registry=None,
) -> tuple[PpermuteProgram, BufferPlan]:
    """Synthesis -> translation -> buffer planning, cached at every layer:
    the algorithm through the (shared) AlgorithmRegistry, the translated
    program here, and the BufferPlan through the executor's plan cache.

    ``spec`` is a :class:`CollectiveSpec` (default route) or a
    :class:`~repro_torch.core.request.CollectiveRequest`, which executes any
    engine route: ``hierarchy="always"``, TE gateway strategies, comm
    sketches, pipelined all-reduce. ``nbytes``/``pipelined_ar`` only apply
    to the CollectiveSpec form; a request carries its own."""
    registry = registry if registry is not None else default_registry()
    req = _as_request(spec, nbytes, pipelined_ar)
    dev_key = (None if device_of_npu is None
               else tuple(sorted(device_of_npu.items())))
    key = (topology_fingerprint(topo), req.fingerprint(), dev_key)
    prog = _PROGRAM_CACHE.get(key)
    if prog is not None:
        _PROGRAM_CACHE.move_to_end(key)
    else:
        engine = _engine_for(topo, registry)
        alg = engine.collective(req)
        alg.validate()
        prog = to_ppermute_program(alg, device_of_npu)
        _PROGRAM_CACHE[key] = prog
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
            _PROGRAM_CACHE.popitem(last=False)
    return prog, plan_buffers_cached(prog, key)


def lower_algorithm(
    alg,
    *,
    key: object = "lowered",
    device_of_npu: dict[int, int] | None = None,
    validate: bool = False,
) -> tuple[PpermuteProgram, BufferPlan]:
    """Lower a pre-synthesized :class:`CollectiveAlgorithm` to an executable
    (program, plan) pair that the ``pccl_*`` primitives accept via their
    ``program=`` argument. ``key`` namespaces the buffer-plan cache entry;
    the program's structural digest keeps distinct schedules apart even
    under one key."""
    if validate:
        alg.validate()
    prog = to_ppermute_program(alg, device_of_npu)
    return prog, plan_buffers_cached(prog, key)


def _group_devices(spec, device_of_npu: dict[int, int] | None) -> list[int]:
    if device_of_npu is None:
        return list(spec.group)
    return [device_of_npu[n] for n in spec.group]


def _member_mask(prog: PpermuteProgram, devices: list[int]) -> np.ndarray:
    mask = np.zeros(prog.num_devices, dtype=bool)
    mask[devices] = True
    return mask


def _resolve(topo, spec, device_of_npu, program, kind):
    """Shared head of the pccl_* primitives: check the kind, fetch or accept
    a (program, plan) pair, map the group onto devices, and build the
    non-participant mask -- devices outside the process group may forward
    traffic but must hand back exact zeros, never forwarded or
    partially-reduced payloads."""
    if spec.kind != kind:
        raise ValueError(f"pccl_{kind} got a spec of kind {spec.kind!r}")
    if program is not None:
        prog, plan = program
    else:
        prog, plan = synthesize_program(topo, spec, device_of_npu=device_of_npu)
    devices = _group_devices(spec, device_of_npu)
    return prog, plan, devices, _member_mask(prog, devices)


def _chunks_by_src(prog: PpermuteProgram, devices: list[int]) -> dict[int, list[int]]:
    out: dict[int, list[int]] = {d: [] for d in devices}
    for chunk, src in sorted(prog.chunk_srcs.items()):
        if src in out:
            out[src].append(chunk)
    return out


# ---------------------------------------------------------------------------
# Layouts: where each input row goes and where each output row comes from,
# per device. The reference builds the same tables (primitives.py:202-370);
# here they drive the torch backends and the numpy interpreter alike.
# ---------------------------------------------------------------------------

@dataclass
class _Layout:
    in_slot: np.ndarray  # [num_devices, k]: slot of input row j (written in j order)
    out_slot: np.ndarray  # [num_devices, m]: slot of output row i
    member: np.ndarray  # [num_devices] bool
    self_row: np.ndarray | None = None  # all_to_all: [num_devices] row kept from x
    _tensors: dict = field(default_factory=dict, repr=False)

    def rows(self, name: str, backend, device) -> torch.Tensor:
        """Table ``name`` as the backend reads it (all rows stacked, one
        rank's row on one rank), on ``device``; built once."""
        key = (name, backend.rank, torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = backend.rows(getattr(self, name), device)
        return self._tensors[key]


def _layout(kind, topo, spec, device_of_npu, program) -> tuple[BufferPlan, _Layout]:
    """The plan and its layout for ``kind``, the layout cached on the plan."""
    prog, plan, devices, member = _resolve(topo, spec, device_of_npu, program, kind)
    lay = plan.cached(("layout", kind, tuple(devices)),
                      lambda: _build_layout(kind, prog, plan, devices, member))
    return plan, lay


def _build_layout(kind, prog, plan, devices, member) -> _Layout:
    n, trash = prog.num_devices, plan.num_slots
    if kind == "all_gather":
        by_src = _chunks_by_src(prog, devices)
        # one chunk per group member; a device outside the group writes its
        # input to slot 0, as the reference does (a forwarder overwrites it)
        in_slot = np.zeros((n, 1), np.int64)
        for dev in devices:
            (chunk,) = by_src[dev]
            in_slot[dev, 0] = plan.slot_of[(dev, chunk)]
        out_slot = plan.slot_table([by_src[d][0] for d in devices])
        return _Layout(in_slot, out_slot, member)
    if kind in ("reduce_scatter", "all_reduce"):
        # chunk k is owned by group member k (condition order = group order);
        # device d's addend for chunk k sits at d's slot for k. Every group
        # member is on every chunk's reduction tree, so the slot exists.
        chunks = sorted(prog.chunk_holders)
        in_slot = np.full((n, len(chunks)), trash, np.int64)
        for ci, c in enumerate(chunks):
            for dev in devices:
                got = plan.slot_of.get((dev, c))
                if got is not None:
                    in_slot[dev, ci] = got
        if kind == "all_reduce":
            assert len(chunks) == len(devices), \
                "all_reduce uses one shard-chunk per member"
            return _Layout(in_slot, plan.slot_table(chunks), member)
        out_slot = np.full((n, 1), trash, np.int64)
        for c in chunks:
            owner = prog.chunk_dests[c][0]
            out_slot[owner, 0] = plan.slot_of[(owner, c)]
        return _Layout(in_slot, out_slot, member)
    # all_to_all: chunk (i -> j) goes from devices[i] to devices[j]
    g = len(devices)
    rank_of_device = {d: r for r, d in enumerate(devices)}
    in_slot = np.full((n, g), trash, np.int64)
    out_slot = np.full((n, g), trash, np.int64)
    self_row = np.zeros(n, np.int64)
    for chunk, src in prog.chunk_srcs.items():
        dst = prog.chunk_dests[chunk][0]
        i, j = rank_of_device[src], rank_of_device[dst]
        in_slot[src, j] = plan.slot_of[(src, chunk)]
        out_slot[dst, i] = plan.slot_of[(dst, chunk)]
    for dev in devices:
        self_row[dev] = rank_of_device[dev]
    return _Layout(in_slot, out_slot, member, self_row)


def _rows_in(kind: str, x, k: int, lead: int):
    """The input as ``[*lead, k, *S]`` rows (``lead`` leading axes: 1
    stacked, 0 on one rank)."""
    if kind == "all_gather":
        return x.reshape(*x.shape[:lead], 1, *x.shape[lead:])
    if kind == "all_reduce":
        d = x.shape[lead]
        if d % k:
            raise ValueError(f"all_reduce splits axis 0 ({d}) into {k} "
                             f"shard-chunks; it must divide")
        return x.reshape(*x.shape[:lead], k, d // k, *x.shape[lead + 1:])
    if x.shape[lead] != k:
        raise ValueError(f"{kind} wants {k} rows on axis 0, got {x.shape[lead]}")
    return x


def _rows_out(kind: str, out, x_shape, lead: int, tiled: bool):
    """``[*lead, m, *S]`` output rows as the kind returns them."""
    if kind == "all_gather" and tiled:
        return out.reshape(*out.shape[:lead], -1, *out.shape[lead + 2:])
    if kind == "reduce_scatter":
        return out.reshape(*out.shape[:lead], *out.shape[lead + 1:])
    if kind == "all_reduce":
        return out.reshape(x_shape)
    return out


def _run(kind, x, topo, spec, device_of_npu, program, backend, tiled=False):
    plan, lay = _layout(kind, topo, spec, device_of_npu, program)
    stacked = backend.rank is None
    lead = int(stacked)
    if stacked and x.shape[0] != plan.num_devices:
        raise ValueError(f"stacked input has {x.shape[0]} rows on axis 0, the "
                         f"program {plan.num_devices} devices")
    xin = _rows_in(kind, x, lay.in_slot.shape[1], lead)
    buf = torch.zeros((*x.shape[:lead], plan.buffer_slots, *xin.shape[lead + 1:]),
                      dtype=x.dtype, device=x.device)
    backend.put(buf, lay.rows("in_slot", backend, x.device), xin)
    execute_program(plan, buf, backend)
    out = backend.gather(buf, lay.rows("out_slot", backend, x.device))
    if lay.self_row is not None:
        # self row: taken from the input (it never leaves the device)
        me = lay.rows("self_row", backend, x.device)
        if stacked:
            dev = torch.arange(x.shape[0], device=x.device)
            out[dev, me] = xin[dev, me]
        else:
            out[me] = xin[me]
    member = lay.rows("member", backend, x.device)
    out.masked_fill_(~member.reshape(*member.shape, *(1,) * (out.ndim - lead)), 0)
    return _rows_out(kind, out, x.shape, lead, tiled)


Backend = StackedBackend | DistBackend


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def pccl_all_gather(x: torch.Tensor, topo: Topology | None, spec, *,
                    device_of_npu: dict[int, int] | None = None,
                    program: tuple[PpermuteProgram, BufferPlan] | None = None,
                    tiled: bool = False, backend: Backend = STACKED) -> torch.Tensor:
    """All-gather x (a device's input, shape S) over the group -> [g, *S]
    in group order (or concatenated on axis 0 when tiled=True). Stacked:
    [n, *S] -> [n, g, *S]. Devices outside the group return zeros."""
    return _run("all_gather", x, topo, spec, device_of_npu, program, backend, tiled)


def pccl_reduce_scatter(x: torch.Tensor, topo: Topology | None, spec, *,
                        device_of_npu: dict[int, int] | None = None,
                        program: tuple[PpermuteProgram, BufferPlan] | None = None,
                        backend: Backend = STACKED) -> torch.Tensor:
    """x: [g, *S] (the addend for each group member); returns this device's
    reduced shard [*S]. Stacked: [n, g, *S] -> [n, *S]. Devices outside the
    group return zeros."""
    return _run("reduce_scatter", x, topo, spec, device_of_npu, program, backend)


def pccl_all_reduce(x: torch.Tensor, topo: Topology | None, spec, *,
                    device_of_npu: dict[int, int] | None = None,
                    program: tuple[PpermuteProgram, BufferPlan] | None = None,
                    backend: Backend = STACKED) -> torch.Tensor:
    """All-reduce x (same shape everywhere) over the group. x is split into
    g shard-chunks along axis 0 (must divide); composition RS then AG.
    Stacked: [n, D, ...] -> [n, D, ...]. Devices outside the group return
    zeros."""
    return _run("all_reduce", x, topo, spec, device_of_npu, program, backend)


def pccl_all_to_all(x: torch.Tensor, topo: Topology | None, spec, *,
                    device_of_npu: dict[int, int] | None = None,
                    program: tuple[PpermuteProgram, BufferPlan] | None = None,
                    backend: Backend = STACKED) -> torch.Tensor:
    """x: [g, *S] where row j is this device's payload for group member j.
    Returns [g, *S] where row i is the payload received from member i (the
    row for self is the device's own, which never leaves it). Stacked:
    [n, g, *S] -> [n, g, *S]. Devices outside the group return zeros."""
    return _run("all_to_all", x, topo, spec, device_of_npu, program, backend)


def interpret_collective(kind: str, x: np.ndarray, topo: Topology | None, spec, *,
                         device_of_npu: dict[int, int] | None = None,
                         program: tuple[PpermuteProgram, BufferPlan] | None = None,
                         tiled: bool = False) -> np.ndarray:
    """``pccl_<kind>`` on a stacked numpy input, in numpy: the same layout
    and rounds (``executor.interpret_rounds``), each step an elementwise
    copy or add in the program's order, so a backend that follows the
    semantics gives the same bits."""
    plan, lay = _layout(kind, topo, spec, device_of_npu, program)
    n = plan.num_devices
    if x.shape[0] != n:
        raise ValueError(f"stacked input has {x.shape[0]} rows, the program {n} devices")
    xin = _rows_in(kind, x, lay.in_slot.shape[1], 1)
    buf = np.zeros((n, plan.buffer_slots, *xin.shape[2:]), x.dtype)
    dev = np.arange(n)
    for j in range(lay.in_slot.shape[1]):
        buf[dev, lay.in_slot[:, j]] = xin[:, j]
    interpret_rounds(plan, buf)
    out = buf[dev[:, None], lay.out_slot]
    if lay.self_row is not None:
        out[dev, lay.self_row] = xin[dev, lay.self_row]
    out[~lay.member] = 0
    return _rows_out(kind, out, x.shape, 1, tiled)
