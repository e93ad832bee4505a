"""Mesh-axis collective planning, ported from ``repro/launch/sharding.py``.

``MeshCollectivePlanner`` (the reference's lines 216-406) is a text copy:
it differs from the reference's only in its import lines, and
``tests/test_torch_port_rules.py`` holds it to that. It imports no jax; the
reference's module does at its top, for ``ShardingPolicy``, which is not
ported yet.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Mesh-axis collectives through the algorithm registry
# ---------------------------------------------------------------------------

class MeshCollectivePlanner:
    """Routes per-mesh-axis process-group collectives through the shared
    :class:`repro.core.registry.AlgorithmRegistry`.

    A (data, model) mesh laid row-major on the physical torus induces one
    process group per row of every axis: ``model``-axis groups vary the last
    axis, ``data``-axis groups the first, etc. All groups of one axis are
    isomorphic under the torus translations, so the registry synthesizes each
    (axis, collective, bytes) combination exactly once and serves every other
    row by relabeling — instead of the old per-row ad-hoc ``synthesize_*``
    calls.

    ``axis_sizes`` is an ordered {axis name: size} whose product must equal
    the NPU count; device index = row-major rank, assumed to coincide with
    the topology's NPU ids (true for ``tpu_v5e_pod``/``torus2d`` meshes, and
    for ``multi_pod`` meshes whose leading axis is the pod axis).

    On partitioned fabrics (``multi_pod`` et al), groups that span pods —
    e.g. the data-parallel axis of a ("pod", "data", "model") mesh — are
    routed through the hierarchical synthesis pipeline automatically (the
    engine's ``hierarchy="auto"``): per-pod phases are synthesized once per
    canonical pod and stitched with an inter-pod phase, instead of paying a
    flat whole-fabric TEN search per group. This covers the reduction
    collectives too — a pod-spanning ``reduce_scatter`` synthesizes as the
    time-reversal of a hierarchical All-Gather on the reversed fabric, and
    ``all_reduce`` composes that with the forward hierarchical All-Gather —
    so the data-parallel gradient path, the dominant collective of
    multi-pod training, takes the scalable route by default. Pass
    ``hierarchy="never"`` to force flat synthesis.

    Fabrics carrying a nested partition tree (``three_level`` et al —
    rack -> pod -> plane) recurse: a plane-spanning group decomposes into a
    plane phase over pod gateways, per-pod phases that themselves decompose
    into rack phases, and canonical per-rack plans registry-shared across
    every isomorphic rack of every pod. ``hierarchy_levels()`` reports how
    deep the routing goes.
    """

    def __init__(self, topo, axis_sizes: dict[str, int], *, registry=None,
                 gateway_strategy: str = "auto", sketch=None):
        from repro_torch.core.engine import SynthesisEngine
        from repro_torch.core.registry import default_registry

        self.topo = topo
        self.axis_sizes = dict(axis_sizes)
        shape = tuple(self.axis_sizes.values())
        if int(np.prod(shape)) != len(topo.npus):
            raise ValueError(
                f"mesh {self.axis_sizes} has {int(np.prod(shape))} devices "
                f"but topology has {len(topo.npus)} NPUs"
            )
        self.registry = registry if registry is not None else default_registry()
        # gateway_strategy/sketch steer the hierarchical inter-pod phase
        # (see repro.core.traffic) — e.g. a CommSketch keeping the
        # data-parallel axis' traffic off a storage plane's uplinks
        self.engine = SynthesisEngine(topo, registry=self.registry,
                                      gateway_strategy=gateway_strategy,
                                      sketch=sketch)
        self._ranks = np.arange(int(np.prod(shape))).reshape(shape)

    def axis_groups(self, axis: str) -> list[list[int]]:
        """Every process group of ``axis``: vary that axis, fix the others."""
        names = list(self.axis_sizes)
        k = names.index(axis)
        moved = np.moveaxis(self._ranks, k, -1)
        return [list(map(int, row)) for row in
                moved.reshape(-1, self.axis_sizes[axis])]

    def spans_pods(self, axis: str) -> bool:
        """True iff this axis' process groups cross a pod boundary (and will
        therefore take the hierarchical synthesis path by default)."""
        if self.topo.partition is None:
            return False
        return self.engine.hierarchical().spans_pods(self.axis_groups(axis)[0])

    def hierarchy_levels(self) -> int:
        """Routing depth of the fabric: 1 = flat, 2 = pods, 3 = pods-of-pods
        (rack -> pod -> plane), i.e. ``partition_depth + 1``. Pod-spanning
        groups synthesize through that many phase levels."""
        return self.topo.partition_depth + 1

    def algorithm(self, kind, axis: str, group_index: int = 0, *,
                  nbytes: float = 1.0, ids=None, **kw):
        """The synthesized (or registry-served) algorithm for one group.

        ``kind`` is either a collective name or a
        :class:`repro.core.request.CollectiveRequest` (its ``group`` is
        filled in from the axis; other fields pass through). The legacy
        string form builds the same request internally from ``nbytes`` and
        the remaining keywords (``chunks_per_npu``/``chunks_per_pair``,
        ``hierarchy``, ``pipelined``, ``root``).

        ``all_gather``/``all_to_all``/``reduce_scatter``/``all_reduce``
        groups that span pods route through the hierarchical pipeline
        automatically; override with ``hierarchy="never"`` (or
        "always")."""
        from repro_torch.core.request import CollectiveRequest

        group = self.axis_groups(axis)[group_index]
        if isinstance(kind, CollectiveRequest):
            if kw:
                raise TypeError(
                    f"pass request fields on the CollectiveRequest, not as "
                    f"keywords: {sorted(kw)}")
            return self.engine.collective(kind.with_group(group), ids=ids)
        if kind not in ("all_gather", "all_to_all", "all_reduce",
                        "reduce_scatter", "reduce"):
            raise ValueError(f"unknown collective kind {kind!r}")
        chunks = kw.pop("chunks_per_npu", None)
        if chunks is None:
            chunks = kw.pop("chunks_per_pair", None)
        req_kw = {"bytes": nbytes}
        if chunks is not None:
            req_kw["chunks"] = chunks
        for f in ("hierarchy", "pipelined", "root"):
            if f in kw:
                req_kw[f] = kw.pop(f)
        if kw:
            raise TypeError(f"unknown keyword(s) {sorted(kw)} for {kind}")
        req = CollectiveRequest(kind, group=tuple(group), **req_kw)
        return self.engine.collective(req, ids=ids)

    def joint(self, parts, *, name: str = "pccl_joint"):
        """Jointly synthesize several mesh-axis collectives over one shared
        TEN (paper §6.4): ``parts`` is a list of ``(kind, axis, group_index)``
        or ``(kind, axis, group_index, nbytes)``. Chunk ids are drawn from
        one ``ChunkIds.split()`` family, so the condition builders cannot
        collide — previously every caller had to hand-thread one allocator.

        Only non-reduction kinds are supported (reductions synthesize via a
        reversed topology and cannot share this TEN).
        """
        from repro_torch.core import conditions as cnd
        from repro_torch.core.conditions import ChunkIds

        builders = {"all_gather": cnd.all_gather, "all_to_all": cnd.all_to_all}
        norm = [(p if len(p) == 4 else (*p, 1.0)) for p in parts]
        ids = ChunkIds()
        groups = []
        for child, (kind, axis, group_index, nbytes) in zip(
                ids.split(len(norm)), norm):
            builder = builders.get(kind)
            if builder is None:
                raise ValueError(
                    f"joint synthesis supports {sorted(builders)}, "
                    f"got {kind!r}"
                )
            group = self.axis_groups(axis)[group_index]
            conds = builder(group, ids=child, bytes=nbytes)
            groups.append((f"{kind}_{axis}{group_index}", conds))
        return self.engine.synthesize_joint(groups, name=name)

    def warm(self, kinds=("all_gather", "reduce_scatter"), *,
             nbytes: float = 1.0) -> dict:
        """Pre-populate the registry for every axis/kind; returns stats.

        Thanks to canonicalization this costs one cold synthesis per
        (axis, kind) — the remaining rows are cache hits."""
        for axis in self.axis_sizes:
            for kind in kinds:
                for i in range(len(self.axis_groups(axis))):
                    self.algorithm(kind, axis, i, nbytes=nbytes)
        return self.registry.stats.as_dict()

    def program(self, kind, axis: str, group_index: int = 0, *,
                nbytes: float = 1.0,
                device_of_npu: dict[int, int] | None = None):
        """(PpermuteProgram, BufferPlan) for executing one group's collective
        inside shard_map — synthesis, translation, and buffer planning all
        cached by fingerprint (see repro.comms).

        ``kind`` is a collective name or a
        :class:`repro.core.request.CollectiveRequest` (group filled in from
        the axis), mirroring :meth:`algorithm` — requests execute any engine
        route (hierarchy, TE gateways, sketches, pipelining)."""
        from repro_torch.comms.primitives import CollectiveSpec, synthesize_program
        from repro_torch.core.request import CollectiveRequest

        group = tuple(self.axis_groups(axis)[group_index])
        if isinstance(kind, CollectiveRequest):
            spec = kind.with_group(group)
        else:
            spec = CollectiveSpec(kind, group)
        return synthesize_program(
            self.topo, spec, nbytes=nbytes, registry=self.registry,
            device_of_npu=device_of_npu,
        )
