"""PlanService: a multi-tenant facade over the algorithm registry.

A fleet runs many jobs against the same fabrics, and every job wants the
same working set of collectives — the (topology, process group, kind)
combinations induced by its mesh axes. The registry already dedupes the
synthesis work (canonicalization) and the disk cache already shares plans
across processes (atomic-rename ``.npz`` entries under ``PCCL_CACHE_DIR``);
the service adds the orchestration layer on top:

* **Planner memoization** — one :class:`MeshCollectivePlanner` per
  (topology, axis layout), so repeated ``plan()`` calls skip mesh/axes
  re-validation and share the planner's engine + TEN.
* **warm()/prefetch** — background-load a fleet's working set through the
  planner, either blocking (returns the registry stats delta) or async on
  a small thread pool (``block=False``; call :meth:`drain` before relying
  on the cache being hot). Thread safety comes from the registry's own
  lock, so warm workers and foreground lookups interleave freely.
* **repair()** — fault-aware incremental plan repair through a memoized
  per-topology :class:`repro.core.repair.PlanRepairer` sharing the same
  registry, with phase-hit/fallback/failure counters in the metrics.
* **metrics()** — hit/miss/disk-hit/eviction counters plus on-disk byte
  traffic, disk-tier eviction counters (``disk_evictions``/``disk_bytes``
  when the shared dir is size-capped via ``max_disk_bytes`` or
  ``PCCL_CACHE_MAX_BYTES``) and warm bookkeeping, for fleet dashboards.

The service lives in ``repro.core`` but imports ``repro.launch`` lazily —
only when a planner is first built — to keep the core layer import-clean.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

from repro_torch.core.registry import AlgorithmRegistry, default_registry

_DEFAULT_KINDS = ("all_gather", "reduce_scatter")


class PlanService:
    """Shared plan cache + prefetch orchestration for one process.

    ``registry`` defaults to the process-wide :func:`default_registry`
    (which honors ``PCCL_CACHE_DIR``); pass ``cache_dir`` to pin a private
    registry to a specific shared directory instead.
    """

    def __init__(self, registry: AlgorithmRegistry | None = None, *,
                 cache_dir: str | None = None, max_entries: int = 256,
                 max_workers: int = 2, max_disk_bytes: int | None = None):
        if registry is None:
            if cache_dir is None:
                cache_dir = os.environ.get("PCCL_CACHE_DIR") or None
            registry = (AlgorithmRegistry(max_entries=max_entries,
                                          cache_dir=cache_dir,
                                          max_disk_bytes=max_disk_bytes)
                        if cache_dir is not None else default_registry())
        self.registry = registry
        self._lock = threading.Lock()
        self._planners: dict[tuple, object] = {}
        self._repairers: dict[int, object] = {}
        self._pool: ThreadPoolExecutor | None = None
        self._max_workers = max_workers
        self._pending: list[Future] = []
        self._warm_requested = 0
        self._warm_completed = 0
        self._warm_failed = 0
        self._repairs = 0
        self._repair_phase_hits = 0  # phase-local repairs served
        self._repair_fallbacks = 0  # fell back to cold degraded resynthesis
        self._repair_failures = 0  # FabricDegradedError raised

    # -- planners -----------------------------------------------------------

    def planner(self, topo, axis_sizes: dict[str, int]):
        """Memoized :class:`repro.launch.sharding.MeshCollectivePlanner`
        for ``(topo, axis_sizes)``, bound to this service's registry."""
        from repro_torch.launch.sharding import MeshCollectivePlanner

        key = (id(topo), tuple(axis_sizes.items()))
        with self._lock:
            pl = self._planners.get(key)
            # id() can be recycled after GC; the identity check makes the
            # memo safe regardless
            if pl is not None and pl.topo is topo:
                return pl
            pl = MeshCollectivePlanner(topo, axis_sizes,
                                       registry=self.registry)
            self._planners[key] = pl
            return pl

    def plan(self, topo, axis_sizes: dict[str, int], kind, axis: str,
             group_index: int = 0, *, nbytes: float = 1.0, **kw):
        """One group's algorithm through the memoized planner — the main
        serving entry point. ``kind`` is a collective name or a
        :class:`repro.core.request.CollectiveRequest` (whose group the
        planner fills in from the axis)."""
        return self.planner(topo, axis_sizes).algorithm(
            kind, axis, group_index, nbytes=nbytes, **kw)

    def program(self, topo, axis_sizes: dict[str, int], kind, axis: str,
                group_index: int = 0, *, nbytes: float = 1.0,
                device_of_npu: dict[int, int] | None = None):
        """One group's executable ``(PpermuteProgram, BufferPlan)`` through
        the memoized planner — what ``repro.comms``' ``pccl_*`` primitives
        take via ``program=`` to run the collective inside shard_map.
        ``kind`` is a name or :class:`~repro.core.request.CollectiveRequest`,
        exactly as in :meth:`plan`."""
        return self.planner(topo, axis_sizes).program(
            kind, axis, group_index, nbytes=nbytes,
            device_of_npu=device_of_npu)

    # -- repair -------------------------------------------------------------

    def repairer(self, topo, *, pipeline: str | bool = "auto"):
        """Memoized :class:`repro.core.repair.PlanRepairer` for ``topo``,
        bound to this service's registry."""
        from repro_torch.core.repair import PlanRepairer

        with self._lock:
            ent = self._repairers.get(id(topo))
            if ent is not None and ent.topology is topo \
                    and ent.pipeline == pipeline:
                return ent
            rp = PlanRepairer(topo, registry=self.registry,
                              pipeline=pipeline)
            self._repairers[id(topo)] = rp
            return rp

    def repair(self, topo, request, event, *, pipeline: str | bool = "auto",
               validate: str | None = "auto"):
        """Repair ``request`` on ``topo`` against a degradation ``event``
        (:class:`repro.core.repair.DegradationEvent`), planning it first
        when this service has no captured record yet. Returns the
        :class:`repro.core.repair.RepairResult`; counts phase-local repairs
        vs cold-resynthesis fallbacks vs loud failures in :meth:`metrics`
        (``repair_phase_hits`` / ``repair_fallbacks`` /
        ``repair_failures``)."""
        from repro_torch.core.errors import FabricDegradedError

        rp = self.repairer(topo, pipeline=pipeline)
        if not rp.recorded(request):
            rp.plan(request)
        with self._lock:
            self._repairs += 1
        try:
            res = rp.repair(request, event, validate=validate)
        except FabricDegradedError:
            with self._lock:
                self._repair_failures += 1
            raise
        with self._lock:
            if res.strategy == "phases":
                self._repair_phase_hits += 1
            else:
                self._repair_fallbacks += 1
        return res

    # -- prefetch -----------------------------------------------------------

    def warm(self, topo, axis_sizes: dict[str, int],
             kinds=_DEFAULT_KINDS, *, nbytes: float = 1.0,
             block: bool = True):
        """Pre-populate the cache with every (axis, kind) group of the mesh.

        Blocking mode returns the registry stats dict (as
        ``MeshCollectivePlanner.warm`` does); ``block=False`` submits the
        same work to a background pool and returns a ``Future`` resolving
        to that dict. Either way the underlying registry absorbs the plans,
        so subsequent :meth:`plan` calls are hits.
        """
        pl = self.planner(topo, axis_sizes)
        self._warm_requested += 1

        def run() -> dict:
            try:
                stats = pl.warm(tuple(kinds), nbytes=nbytes)
            except Exception:
                with self._lock:
                    self._warm_failed += 1
                raise
            with self._lock:
                self._warm_completed += 1
            return stats

        if block:
            return run()
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="pccl-warm")
            fut = self._pool.submit(run)
            self._pending.append(fut)
            return fut

    def drain(self, timeout: float | None = None) -> None:
        """Wait for every outstanding background warm to finish."""
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            try:
                fut.result(timeout=timeout)
            except Exception:
                pass  # failure already counted; plans stay best-effort

    # -- observability ------------------------------------------------------

    def metrics(self) -> dict:
        """Registry counters + warm bookkeeping, one flat dict."""
        out = self.registry.stats.as_dict()
        with self._lock:
            out.update(
                entries=len(self.registry),
                planners=len(self._planners),
                warm_requested=self._warm_requested,
                warm_completed=self._warm_completed,
                warm_failed=self._warm_failed,
                repairs=self._repairs,
                repair_phase_hits=self._repair_phase_hits,
                repair_fallbacks=self._repair_fallbacks,
                repair_failures=self._repair_failures,
            )
        return out

    def close(self) -> None:
        """Shut the warm pool down (idempotent)."""
        with self._lock:
            pool, self._pool = self._pool, None
            self._pending = []
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
