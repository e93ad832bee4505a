"""The unified PCCL exception surface.

Every domain error the synthesis stack raises derives from
:class:`PCCLError`, so callers can catch one base type at the serving
boundary. The subclasses differ in one load-bearing way: whether the
engine's *silent flat fallback* (retry the collective as a flat
whole-fabric synthesis when the hierarchical route fails) is allowed to
swallow them. The contract, asserted by ``tests/test_request.py``:

``HierarchyError``
    Advisory. "This group/fabric cannot take the hierarchical path"
    (no partition, single pod, missing gateways, unreachable pods). The
    engine's ``hierarchy="auto"`` route MAY catch it and fall back to flat
    synthesis — the flat plan fulfils the same conditions, just without the
    pod decomposition. The fallback is forbidden only when the caller
    pinned the route (``hierarchy="always"``) or a :class:`CommSketch` is
    attached (flat synthesis would ignore its hard constraints).

``SketchInfeasibleError``
    Hard. A sketch constraint cannot be satisfied. Deliberately NOT a
    ``HierarchyError`` subclass: it must never ride the flat fallback,
    because a flat plan would silently ignore the operator's constraints.

``FabricDegradedError``
    Hard, and louder still: the *surviving* fabric cannot fulfil the
    requested collective at all (a group member unreachable, a pod's sole
    gateway dead with no boundary alternative). No fallback of any kind
    may produce a schedule — a degraded fabric must either yield a plan
    that validates end to end or fail with this error. Raised by
    :mod:`repro.core.repair`.
"""

from __future__ import annotations

__all__ = ["PCCLError", "FabricDegradedError"]


class PCCLError(Exception):
    """Base of every PCCL domain error (see the module docstring for the
    per-subclass silent-fallback rules)."""


class FabricDegradedError(PCCLError, RuntimeError):
    """The surviving (degraded) fabric cannot fulfil the requested
    collective: repair and cold resynthesis are both impossible. Never
    swallowed — no fallback path may turn this into a schedule."""
