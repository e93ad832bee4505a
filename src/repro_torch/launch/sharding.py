"""Sharding rules and mesh-axis collective planning, ported from
``repro/launch/sharding.py``.

Strategy, as the reference's: Megatron-style tensor parallelism on the
"model" axis + ZeRO/FSDP sharding of the complementary weight dim on the
"data" axis + pure data parallelism on the "pod" axis, with sequence
parallelism (residual activations sharded on seq over "model") bounding
activation memory.

A spec is a tuple with one entry a tensor dimension: an axis name, a tuple
of axis names (split major to minor) or None, the entries of the
reference's ``PartitionSpec``. :class:`ShardingPolicy` reads only the
mesh's axis names and sizes, so the specs of a production mesh are
computed without its ranks; :meth:`ShardingPolicy.placements` turns a spec
into DTensor placements on the mesh's ``DeviceMesh``.

``pad_heads`` is a text copy of the reference's (lines 30-39). Padding
does not keep a model's function by itself, whatever the reference's
module docstring says: ``attention_init`` draws a random ``wo`` for every
head, the pad heads included, and padding regroups GQA (head ``h`` reads KV
head ``h // (H / KV)``). ``bridge.pad_head_params`` carries an unpadded
model's weights into the padded config so that the function is kept.

``MeshCollectivePlanner`` (the reference's lines 216-406) is a text copy:
it differs from the reference's only in its import lines, and
``tests/test_torch_port_rules.py`` holds it to that. This module imports
no jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig


def P(*dims) -> tuple:
    """A spec: one entry a dimension (the reference's ``PartitionSpec``)."""
    return tuple(dims)


def pad_heads(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad num_heads up to a multiple of tp (keeping GQA grouping legal)."""
    h = cfg.num_heads
    if h % tp == 0 or cfg.family == "ssm":
        return cfg
    hp = ((h + tp - 1) // tp) * tp
    # keep grouping divisible: hp must be a multiple of kv heads
    while hp % cfg.num_kv_heads:
        hp += tp
    return dataclasses.replace(cfg, num_heads=hp)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


@dataclass(eq=False)
class ShardingPolicy:
    """The reference's rules on a :class:`repro_torch.launch.mesh.Mesh`.
    The spec methods read the mesh's names and sizes only; the methods that
    place, move or take apart tensors need its ``DeviceMesh``."""

    mesh: object
    cfg: ModelConfig

    def __post_init__(self):
        names = tuple(self.mesh.axis_names)
        sizes = dict(zip(names, self.mesh.shape))
        self.tp = "model" if "model" in names else None
        self.tp_size = sizes.get("model", 1)
        dp = tuple(a for a in ("pod", "data") if a in names)
        self.dp = dp if len(dp) > 1 else (dp[0] if dp else None)
        self.dp_size = int(np.prod([sizes[a] for a in ("pod", "data")
                                    if a in names]))
        self.fsdp = "data" if "data" in names else None
        self.fsdp_size = sizes.get("data", 1)
        self.all_axes = names
        self.total = int(np.prod(self.mesh.shape))

    # -- helpers -----------------------------------------------------------
    def _div(self, dim: int, axis, size: int):
        """axis if dim divides evenly, else None (replicate)."""
        return axis if axis is not None and dim % size == 0 and size > 1 else None

    # -- parameter specs ----------------------------------------------------
    def param_spec(self, path: tuple, leaf) -> tuple:
        """The spec of the parameter at ``path`` (dict keys) of ``leaf``'s
        shape: the reference's rules, line for line."""
        cfg = self.cfg
        names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
        last = names[-1]
        shape = leaf.shape
        stacked = ("layers" in names or "enc_layers" in names
                   or "tail_layers" in names)
        pre = (None,) if stacked else ()
        tp, fsdp = self.tp, self.fsdp

        def spec(*dims):
            return P(*pre, *dims)

        if last == "table":  # embedding [V, d]
            v_ax = self._div(shape[0], tp, self.tp_size)
            if v_ax:
                return P(v_ax, self._div(shape[1], fsdp, self.fsdp_size))
            return P(None, self._div(shape[1], fsdp, self.fsdp_size))
        if names[-2] == "unembed":  # [d, V]
            return P(self._div(shape[0], fsdp, self.fsdp_size),
                     self._div(shape[1], tp, self.tp_size))
        if last in ("wq",):
            return spec(self._div(shape[-2], fsdp, self.fsdp_size),
                        self._div(shape[-1], tp, self.tp_size))
        if last in ("wk", "wv"):
            kv_ok = cfg.num_kv_heads % self.tp_size == 0
            return spec(self._div(shape[-2], fsdp, self.fsdp_size),
                        tp if kv_ok and self.tp_size > 1 else None)
        if last == "wo":
            return spec(self._div(shape[-2], tp, self.tp_size),
                        self._div(shape[-1], fsdp, self.fsdp_size))
        if last in ("gate", "up"):
            if len(shape) == len(pre) + 3:  # MoE experts [*, E, d, ffe]
                return spec(self._div(shape[-3], tp, self.tp_size),
                            self._div(shape[-2], fsdp, self.fsdp_size), None)
            return spec(self._div(shape[-2], fsdp, self.fsdp_size),
                        self._div(shape[-1], tp, self.tp_size))
        if last == "down":
            if len(shape) == len(pre) + 3:  # MoE [*, E, ffe, d]
                return spec(self._div(shape[-3], tp, self.tp_size), None,
                            self._div(shape[-1], fsdp, self.fsdp_size))
            return spec(self._div(shape[-2], tp, self.tp_size),
                        self._div(shape[-1], fsdp, self.fsdp_size))
        if last == "router":
            return spec(self._div(shape[-2], fsdp, self.fsdp_size), None)
        if last in ("w_z", "w_x"):  # [*, d, d_inner] head-parallel
            return spec(self._div(shape[-2], fsdp, self.fsdp_size),
                        self._div(shape[-1], tp, self.tp_size))
        if last in ("w_B", "w_C"):  # group-shared: replicate state dim
            return spec(self._div(shape[-2], fsdp, self.fsdp_size), None)
        if last == "w_dt":
            return spec(self._div(shape[-2], fsdp, self.fsdp_size),
                        self._div(shape[-1], tp, self.tp_size))
        if last == "conv_x":
            return spec(None, self._div(shape[-1], tp, self.tp_size))
        if last in ("conv_B", "conv_C"):
            return spec(None, None)
        if last in ("dt_bias", "A_log", "D"):
            return spec(self._div(shape[-1], tp, self.tp_size))
        if last == "out_proj":  # [*, d_inner, d]
            return spec(self._div(shape[-2], tp, self.tp_size),
                        self._div(shape[-1], fsdp, self.fsdp_size))
        if last == "norm_scale":
            return spec(self._div(shape[-1], tp, self.tp_size))
        if last == "scale":  # RMSNorm
            return spec(None)
        # default: replicate
        return P(*((None,) * len(shape)))

    def param_specs(self, params):
        return _tree_map_with_path(self.param_spec, params)

    def param_shardings(self, params):
        """``params`` placed on the mesh: each leaf a DTensor split by its
        spec (``distribute_tensor``; every rank passes the same tree)."""
        from torch.distributed.tensor import distribute_tensor

        return _tree_map_with_path(
            lambda path, leaf: distribute_tensor(
                leaf, self.device_mesh, self.placements(self.param_spec(path, leaf))),
            params)

    # -- activation specs ---------------------------------------------------
    @property
    def seq_spec(self) -> tuple:
        """Residual stream [B, S, d]: batch on DP, seq on TP (Megatron SP)."""
        return P(self.dp, self.tp, None)

    def batch_spec(self, batch_size: int, seq_len: int) -> tuple:
        """Token batches [B, S]."""
        dp = self.dp if batch_size % self.dp_size == 0 else None
        s = self.tp if seq_len % max(self.tp_size, 1) == 0 else None
        return P(dp, s)

    def token_spec(self, batch_size: int) -> tuple:
        return P(self.dp if batch_size % self.dp_size == 0 else None)

    def kv_cache_spec(self, batch_size: int, seq_len: int) -> tuple:
        """[L, B, S, KV, hd]: batch on DP, seq on TP; batch-1 long-context
        shards seq over every axis (256/512-way context parallelism)."""
        if batch_size == 1:
            all_sz = self.total
            s = self.all_axes if seq_len % all_sz == 0 else (
                self.tp if seq_len % self.tp_size == 0 else None)
            return P(None, None, s, None, None)
        dp = self.dp if batch_size % self.dp_size == 0 else None
        s = self.tp if seq_len % max(self.tp_size, 1) == 0 else None
        return P(None, dp, s, None, None)

    def ssm_cache_spec(self, field: str, batch_size: int, leaf) -> tuple:
        dp = self.dp if batch_size % self.dp_size == 0 else None
        if field == "state":  # [L, B, H, P, N]
            h = self.tp if leaf.shape[2] % max(self.tp_size, 1) == 0 else None
            return P(None, dp, h, None, None)
        if field == "conv_x":  # [L, B, K-1, d_inner]
            c = self.tp if leaf.shape[3] % max(self.tp_size, 1) == 0 else None
            return P(None, dp, None, c)
        return P(None, dp, None, None)  # conv_B / conv_C

    def cache_shardings(self, cache, batch_size: int):
        """The spec of every leaf of a decode cache (shape-aware): the
        reference's NamedShardings' specs."""

        def spec_for(path, leaf):
            if "kv" in path or "cross" in path:
                return self.kv_cache_spec(batch_size, leaf.shape[2])
            return self.ssm_cache_spec(path[-1], batch_size, leaf)

        return _tree_map_with_path(spec_for, cache)

    def logits_spec(self, batch_size: int) -> tuple:
        dp = self.dp if batch_size % self.dp_size == 0 else None
        v = self.tp if self.cfg.vocab_size % max(self.tp_size, 1) == 0 else None
        return P(dp, v)

    def collective_planner(self, topo, registry=None) -> "MeshCollectivePlanner":
        """A planner for this policy's mesh over the physical fabric."""
        return MeshCollectivePlanner(
            topo,
            dict(zip(self.mesh.axis_names, self.mesh.shape)),
            registry=registry,
        )

    # -- DTensor placements ---------------------------------------------------
    @property
    def device_mesh(self):
        return self.mesh.device_mesh

    def placements(self, spec: tuple, partial=()) -> list:
        """DTensor placements of ``spec``, one a mesh axis: ``Shard(i)`` on
        the axis that splits dimension ``i``, ``Partial()`` on the axes
        named in ``partial``, ``Replicate()`` elsewhere. A dimension split
        over several axes lists them major to minor, as DTensor splits it
        (a mesh axis further left splits first): the reference's order."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        out = []
        for axis in self.all_axes:
            dims = [i for i, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            if len(dims) > 1:
                raise ValueError(f"axis {axis!r} splits dims {dims} of {spec}")
            if axis in partial:
                if dims:
                    raise ValueError(f"axis {axis!r} both splits and sums {spec}")
                out.append(Partial())
            else:
                out.append(Shard(dims[0]) if dims else Replicate())
        for e in spec:
            if isinstance(e, tuple) and list(e) != [a for a in self.all_axes if a in e]:
                raise ValueError(f"{e} is not in the mesh's order {self.all_axes}")
        return out

    def constrain(self, x, spec: tuple):
        """``x`` (a DTensor) moved to ``spec``."""
        return x.redistribute(self.device_mesh, self.placements(spec))

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_coordinate()[self.all_axes.index(axis)]

    def from_local(self, x, spec: tuple, partial=()):
        """The DTensor whose local shard on this rank is ``x``; a sum over
        the ``partial`` axes."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(x, self.device_mesh, self.placements(spec, partial),
                                  run_check=False)

    def to_local(self, x, spec: tuple, split=()):
        """``x`` (a DTensor) moved to ``spec``, then its local shard. The
        gradient of the shard is taken as this rank's part of a sum over the
        axes in ``split`` that ``spec`` replicates (each rank used the
        tensor on its own tokens), and as the whole gradient on the others
        (each rank computed the same thing)."""
        tgt = self.placements(spec)
        grad = self.placements(spec, partial=[a for a, p in zip(self.all_axes, tgt)
                                              if a in split and p.is_replicate()])
        return x.redistribute(self.device_mesh, tgt).to_local(grad_placements=grad)

    def weight(self, w, split=()):
        """The local weight of a DTensor param for one use: gathered over the
        data-parallel axes (FSDP), split on "model" as its spec splits it;
        its gradient summed over the ``split`` axes (``to_local``)."""
        spec = self.spec_of(w)
        return self.to_local(w, tuple(e if e == self.tp else None for e in spec), split)

    def spec_of(self, x) -> tuple:
        """The spec of a DTensor's placements (one axis a dimension)."""
        spec = [None] * x.ndim
        for axis, p in zip(self.all_axes, x.placements):
            if p.is_shard():
                d = p.dim % x.ndim
                spec[d] = axis if spec[d] is None else (
                    (*spec[d], axis) if isinstance(spec[d], tuple) else (spec[d], axis))
        return tuple(spec)


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
