"""Fault tolerance for large-scale training: failure handling, elastic
re-meshing, and straggler mitigation.

At 1000+ node scale, node failure is a *when*, not an *if* (MTBF of a
10k-chip job is measured in hours). The policy layer here is hardware-
independent and fully unit-testable on CPU:

* :class:`FaultToleranceManager` — drives the checkpoint/restore/restart
  loop: on failure, pick the newest complete checkpoint, compute the
  surviving device set, re-mesh, restore (resharding onto the new mesh),
  and resume the data pipeline at the restored step (deterministic batches
  make this bit-exact).
* :class:`ElasticMeshPlanner` — given surviving chip count, choose the
  largest (data, model) mesh that preserves the model-parallel degree
  (TP degree is a property of the checkpoint's sharding; DP shrinks).
* :class:`StragglerMonitor` — per-step duration tracking with a robust
  deadline (median x tolerance); slow steps raise a straggler verdict that
  the training loop answers by skipping the straggler's microbatch
  contribution (gradient accumulation re-normalizes) or re-meshing the
  node away after `evict_after` consecutive verdicts.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class ElasticMeshPlanner:
    model_degree: int  # TP degree — fixed by the checkpoint's layout
    pod_size: int = 256

    def plan(self, surviving_chips: int) -> tuple[int, int]:
        """Largest (data, model) mesh with `model_degree` TP that fits the
        survivors. Data degree must keep at least 1."""
        if surviving_chips < self.model_degree:
            raise RuntimeError(
                f"cannot keep TP={self.model_degree} with only "
                f"{surviving_chips} chips")
        data = surviving_chips // self.model_degree
        return data, self.model_degree

    def plan_multi_pod(self, surviving_per_pod: list[int]):
        """Per-pod plan: each pod keeps its own (data, model); pods whose
        survivors can't host one TP group drop out of the job."""
        plans = []
        for chips in surviving_per_pod:
            if chips >= self.model_degree:
                plans.append(self.plan(chips))
        if not plans:
            raise RuntimeError("no pod can host a model-parallel group")
        # keep the common (minimum) data degree so pods stay symmetric
        data = min(d for d, _ in plans)
        return [(data, self.model_degree)] * len(plans)


@dataclass
class StragglerMonitor:
    tolerance: float = 2.0  # step slower than median x tolerance => straggler
    window: int = 32
    evict_after: int = 3
    _durations: list[float] = field(default_factory=list)
    _consecutive: int = 0
    evictions: int = 0

    def record(self, duration_s: float) -> str:
        """Returns 'ok' | 'straggler' | 'evict'."""
        history = self._durations[-self.window:]
        self._durations.append(duration_s)
        if len(history) < 5:
            return "ok"
        med = statistics.median(history)
        if duration_s <= med * self.tolerance:
            self._consecutive = 0
            return "ok"
        self._consecutive += 1
        if self._consecutive >= self.evict_after:
            self._consecutive = 0
            self.evictions += 1
            return "evict"
        return "straggler"

    @property
    def median(self) -> float:
        return statistics.median(self._durations) if self._durations else 0.0


@dataclass
class FaultToleranceManager:
    """Orchestrates recovery. All side effects are injected (checkpointer,
    mesh builder, pipeline factory) so the policy is testable without
    hardware.

    When a ``plan_service`` (:class:`repro.core.planservice.PlanService`)
    and ``topology`` are attached, the manager also re-plans the job's
    registered collectives for the surviving fabric on failure: register
    each :class:`repro.core.request.CollectiveRequest` the job runs via
    :meth:`register_collective`, and :meth:`recover` (given the
    ``degradation`` event) repairs them incrementally alongside the
    elastic re-mesh — phase-local where the damage allows, cold degraded
    resynthesis otherwise, and a loud
    :class:`repro.core.errors.FabricDegradedError` when the survivors
    cannot fulfil a collective at all."""

    checkpointer: object  # repro.checkpoint.Checkpointer
    planner: ElasticMeshPlanner
    make_mesh: Callable[[int, int], object]  # (data, model) -> mesh
    restarts: int = 0
    max_restarts: int = 100
    plan_service: object | None = None  # repro.core.planservice.PlanService
    topology: object | None = None  # the physical fabric the job runs on
    _collectives: list = field(default_factory=list)
    replanned: dict = field(default_factory=dict)

    def register_collective(self, request) -> None:
        """Track a collective this job depends on, for re-planning on
        failure. Planning happens lazily at the first repair (the service
        captures the healthy-fabric phase record then)."""
        if not any(r.fingerprint() == request.fingerprint()
                   for r in self._collectives):
            self._collectives.append(request)

    def replan_collectives(self, degradation, *,
                           validate: str | None = "auto") -> dict:
        """Repair every registered collective against ``degradation``
        (:class:`repro.core.repair.DegradationEvent`) on the surviving
        fabric; returns {request fingerprint: RepairResult} and keeps it
        on ``self.replanned``. A FabricDegradedError propagates — a job
        whose collective cannot be fulfilled must not resume on a silently
        broken schedule."""
        if self.plan_service is None or self.topology is None:
            raise RuntimeError(
                "collective re-planning needs plan_service= and topology=")
        out = {}
        for req in self._collectives:
            out[req.fingerprint()] = self.plan_service.repair(
                self.topology, req, degradation, validate=validate)
        self.replanned = out
        return out

    def recover(self, template: dict, surviving_chips: int,
                shardings_for_mesh: Callable[[object], dict],
                degradation=None):
        """Failure path: plan a new mesh from survivors, restore the newest
        checkpoint resharded onto it, and report the step to resume from.
        With a ``degradation`` event (and an attached plan service), the
        registered collectives are re-planned for the surviving fabric
        first — so an unfulfillable fabric fails loudly before any restore
        work happens.

        Returns (step, state, mesh)."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError("restart budget exhausted")
        if degradation is not None and self._collectives:
            self.replan_collectives(degradation)
        data, model = self.planner.plan(surviving_chips)
        mesh = self.make_mesh(data, model)
        shardings = shardings_for_mesh(mesh)
        step, state = self.checkpointer.restore(template,
                                                shardings=shardings)
        return step, state, mesh


class StepTimer:
    """Context manager feeding the straggler monitor."""

    def __init__(self, monitor: StragglerMonitor):
        self.monitor = monitor
        self.verdict = "ok"

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.verdict = self.monitor.record(time.monotonic() - self._t0)
        return False
