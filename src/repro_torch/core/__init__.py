"""The port's copy of the PCCL planner core (``repro/core``): process
group-aware collective synthesis, the validation oracle, the algorithm
registry, the translation to rounds of sends, fault-aware plan repair, the
baselines and the alpha-beta simulator.

The modules here are copies of the reference's: they differ from it only in
their import lines and in marked fixes (``registry._store_disk``; the
repair's local-phase failure in ``hierarchy``; path-finding scratch per
thread; finite switch buffers kept over a chunk's whole stay in ``ten``,
``pathfinding`` and ``engine``), and ``tests/test_torch_port_rules.py``
holds them to that. This module exports
every name the reference's ``repro.core`` exports.
"""

from repro_torch.core.algorithm import (
    CollectiveAlgorithm,
    Transfer,
    TransferColumns,
    TransferList,
)
from repro_torch.core.conditions import (
    ChunkIds,
    Condition,
    ReduceCondition,
    all_gather,
    all_reduce,
    all_to_all,
    all_to_allv,
    broadcast,
    gather,
    multicast,
    point_to_point,
    reduce,
    reduce_scatter,
    scatter,
)
from repro_torch.core.engine import PhasePlan, PhaseSpec, SynthesisEngine
from repro_torch.core.errors import FabricDegradedError, PCCLError
from repro_torch.core.hierarchy import HierarchicalSynthesizer, HierarchyError
from repro_torch.core.repair import (
    DamageReport,
    DegradationEvent,
    PlanRepairer,
    RepairResult,
)
from repro_torch.core.request import (
    CollectiveRequest,
    PCCLDeprecationWarning,
)
from repro_torch.core.traffic import CommSketch, SketchInfeasibleError, \
    TrafficEngineer
from repro_torch.core.registry import (
    AlgorithmRegistry,
    canonicalize_group,
    default_registry,
    enumerate_automorphisms,
    is_automorphism,
    relabel_algorithm,
    topology_fingerprint,
)
from repro_torch.core.synthesizer import (
    order_conditions,
    synthesize,
    synthesize_all_gather,
    synthesize_all_reduce,
    synthesize_all_to_all,
    synthesize_joint,
    synthesize_reduce,
    synthesize_reduce_scatter,
)
from repro_torch.core.simulator import (
    Flow,
    SimResult,
    collective_bandwidth,
    phase_breakdown,
    replay_algorithm,
    simulate_flows,
)
from repro_torch.core.baselines import (
    direct_all_gather,
    direct_all_to_all,
    ring_all_gather,
    shortest_path_links,
)
from repro_torch.core.translate import (
    PpermuteProgram,
    Send,
    from_msccl_json,
    to_msccl_json,
    to_ppermute_program,
)
from repro_torch.core.planservice import PlanService
from repro_torch.core.serialize import (
    load_plan_npz,
    plan_disk_bytes,
    save_plan_npz,
)

__all__ = [
    "CollectiveAlgorithm",
    "Transfer",
    "TransferColumns",
    "TransferList",
    "PlanService",
    "load_plan_npz",
    "plan_disk_bytes",
    "save_plan_npz",
    "SynthesisEngine",
    "PhasePlan",
    "PhaseSpec",
    "HierarchicalSynthesizer",
    "HierarchyError",
    "PCCLError",
    "FabricDegradedError",
    "CollectiveRequest",
    "PCCLDeprecationWarning",
    "DamageReport",
    "DegradationEvent",
    "PlanRepairer",
    "RepairResult",
    "CommSketch",
    "SketchInfeasibleError",
    "TrafficEngineer",
    "AlgorithmRegistry",
    "canonicalize_group",
    "default_registry",
    "enumerate_automorphisms",
    "is_automorphism",
    "relabel_algorithm",
    "topology_fingerprint",
    "ChunkIds",
    "Condition",
    "ReduceCondition",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "all_to_allv",
    "broadcast",
    "gather",
    "multicast",
    "point_to_point",
    "reduce",
    "reduce_scatter",
    "scatter",
    "order_conditions",
    "synthesize",
    "synthesize_all_gather",
    "synthesize_all_reduce",
    "synthesize_all_to_all",
    "synthesize_joint",
    "synthesize_reduce",
    "synthesize_reduce_scatter",
    "Flow",
    "SimResult",
    "collective_bandwidth",
    "phase_breakdown",
    "replay_algorithm",
    "simulate_flows",
    "direct_all_gather",
    "direct_all_to_all",
    "ring_all_gather",
    "shortest_path_links",
    "PpermuteProgram",
    "Send",
    "from_msccl_json",
    "to_msccl_json",
    "to_ppermute_program",
]
