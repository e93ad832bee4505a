from repro_torch.topology.topology import Link, Node, NodeType, Topology, TopologyView
from repro_torch.topology.generators import (
    ring,
    line,
    mesh2d,
    torus2d,
    torus3d,
    hypercube,
    star_switch,
    two_level_switch,
    tpu_v5e_pod,
    multi_pod,
    three_level,
)

__all__ = [
    "Link",
    "Node",
    "NodeType",
    "Topology",
    "TopologyView",
    "ring",
    "line",
    "mesh2d",
    "torus2d",
    "torus3d",
    "hypercube",
    "star_switch",
    "two_level_switch",
    "tpu_v5e_pod",
    "multi_pod",
    "three_level",
]
