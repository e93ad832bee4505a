"""CollectiveRequest: one frozen value object per collective call.

The engine's named collectives historically grew a kwarg per tuning knob
(``bytes=``, ``chunks_per_npu=``/``chunks_per_pair=``, ``pipelined=``,
``hierarchy=``) plus two engine-level settings (``gateway_strategy``,
``sketch``) that silently changed what the same call meant on different
engines. :class:`CollectiveRequest` folds all of it into one frozen,
validated dataclass:

* ``SynthesisEngine.collective(request)`` is the primary entry point;
  ``MeshCollectivePlanner.algorithm(request, ...)`` and
  ``PlanService.plan(topo, axis_sizes, request, ...)`` accept the same
  object. The registry route params derive from the request
  (:meth:`CollectiveRequest.registry_params`), reproducing the legacy
  tuples bit-for-bit so pre-existing cache entries keep serving.
* The legacy per-call kwargs survive as thin shims on the named methods;
  explicitly passing one emits :class:`PCCLDeprecationWarning` (escalated
  to an error for ``repro``-internal call sites by the pytest config).
* ``ids=`` (the caller's chunk-id allocator) stays a call-site argument —
  it is identity-bearing mutable state, not a description of the
  collective, so it never belongs in the frozen request.

``chunks`` is the per-NPU chunk count for the gather/reduce-scatter family
and the per-pair count for all_to_all — the one knob the legacy API spelled
two ways (``chunks_per_npu``/``chunks_per_pair``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace

__all__ = [
    "COLLECTIVE_KINDS",
    "CollectiveRequest",
    "PCCLDeprecationWarning",
]

COLLECTIVE_KINDS = (
    "all_gather", "all_to_all", "reduce", "reduce_scatter", "all_reduce",
)

# distinguishes "kwarg left at default" from "kwarg explicitly passed" in
# the legacy shims, so bare eng.all_gather(group) stays warning-free sugar
_UNSET = object()


class PCCLDeprecationWarning(DeprecationWarning):
    """Deprecation of the per-call kwarg API in favour of
    :class:`CollectiveRequest`. A dedicated subclass so the test suite can
    escalate exactly PCCL's own deprecations to errors without tripping
    over third-party ones."""


@dataclass(frozen=True)
class CollectiveRequest:
    """A complete, immutable description of one collective synthesis.

    ``group`` may be left empty when a layer upstream fills it in (e.g.
    ``MeshCollectivePlanner`` deriving it from a mesh axis) — see
    :meth:`with_group`. ``gateway_strategy``/``sketch`` of ``None`` mean
    "inherit the engine's configuration"; setting either makes the engine
    synthesize through a variant configured accordingly.
    """

    kind: str
    group: tuple = ()
    bytes: float = 1.0
    chunks: int = 1  # per-NPU (gather family) / per-pair (all_to_all)
    root: int | None = None  # reduce only
    hierarchy: str = "auto"
    pipelined: bool = False  # all_reduce flat route only
    gateway_strategy: str | None = None  # None = engine default
    sketch: object | None = None  # CommSketch | None; None = engine default

    def __post_init__(self):
        if self.kind not in COLLECTIVE_KINDS:
            raise ValueError(
                f"kind={self.kind!r} not in {COLLECTIVE_KINDS}")
        object.__setattr__(
            self, "group", tuple(int(n) for n in self.group))
        object.__setattr__(self, "bytes", float(self.bytes))
        object.__setattr__(self, "chunks", int(self.chunks))
        if self.bytes <= 0.0:
            raise ValueError(f"bytes={self.bytes} must be positive")
        if self.chunks < 1:
            raise ValueError(f"chunks={self.chunks} must be >= 1")
        if self.hierarchy not in ("auto", "always", "never"):
            raise ValueError(
                f"hierarchy={self.hierarchy!r} not in auto/always/never")
        if self.kind == "reduce":
            if self.root is None:
                raise ValueError("reduce needs root=")
            object.__setattr__(self, "root", int(self.root))
            if self.group and self.root not in self.group:
                raise ValueError(
                    f"root {self.root} not in group")
        elif self.root is not None:
            raise ValueError(f"root= only applies to reduce, not {self.kind}")
        if self.pipelined and self.kind != "all_reduce":
            raise ValueError(
                f"pipelined= only applies to all_reduce, not {self.kind}")
        if self.sketch is not None and not hasattr(self.sketch, "fingerprint"):
            raise TypeError("sketch must be a CommSketch (needs fingerprint())")

    def with_group(self, group) -> "CollectiveRequest":
        """This request bound to a concrete process group."""
        return replace(self, group=tuple(int(n) for n in group))

    def registry_params(self, route) -> tuple:
        """The registry key's params tuple — bit-identical to what the
        legacy kwarg API produced, so plans cached before the redesign (and
        across old/new call forms) keep serving.

        ``route`` is the resolved hierarchical-route tuple from
        ``SynthesisEngine._route_hierarchical`` (unused for reduce, which
        never routes hierarchically and keys on the root's position)."""
        if self.kind == "reduce":
            return (self.bytes, self.group.index(self.root))
        if self.kind == "all_reduce":
            return (self.bytes, self.pipelined, route)
        # all_gather / all_to_all / reduce_scatter
        return (self.bytes, self.chunks, route)

    def fingerprint(self) -> str:
        """Stable identity for memo keys (plan repair records, service
        caches). Not the registry key — the registry canonicalizes groups
        and adds the topology fingerprint itself."""
        sk = self.sketch.fingerprint() if self.sketch is not None else None
        payload = repr((self.kind, self.group, self.bytes, self.chunks,
                        self.root, self.hierarchy, self.pipelined,
                        self.gateway_strategy, sk))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]
