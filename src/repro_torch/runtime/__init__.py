from repro_torch.runtime.fault_tolerance import (
    ElasticMeshPlanner,
    FaultToleranceManager,
    StragglerMonitor,
)

__all__ = ["ElasticMeshPlanner", "FaultToleranceManager", "StragglerMonitor"]
