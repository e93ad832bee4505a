"""Standard topology generators used in the paper's evaluation and ours.

All generators return NPU-dense topologies (NPU ids 0..n-1 first, switch ids
after) so process groups can be specified directly as NPU-id lists.

Unless stated otherwise links are bidirectional (one directed link each way)
and homogeneous with (alpha, beta) given by the caller. The paper's
homogeneous experiments use unit link time: alpha=0, beta=1 with chunk
bytes=1 -> 1 us per hop per chunk.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.topology.topology import NodeType, Topology


def ring(n: int, alpha: float = 0.0, beta: float = 1.0, bidirectional: bool = False) -> Topology:
    """Unidirectional (default) or bidirectional ring of n NPUs (paper Fig. 4a)."""
    topo = Topology(f"ring{n}{'_bidir' if bidirectional else ''}")
    topo.add_npus(n)
    for i in range(n):
        topo.add_link(i, (i + 1) % n, alpha, beta)
        if bidirectional:
            topo.add_link((i + 1) % n, i, alpha, beta)
    topo.automorphism_generators = [tuple((i + 1) % n for i in range(n))]
    return topo


def line(n: int, alpha: float = 0.0, beta: float = 1.0) -> Topology:
    """Bidirectional line (path) of n NPUs."""
    topo = Topology(f"line{n}")
    topo.add_npus(n)
    for i in range(n - 1):
        topo.add_bidir_link(i, i + 1, alpha, beta)
    return topo


def mesh2d(rows: int, cols: int, alpha: float = 0.0, beta: float = 1.0) -> Topology:
    """Bidirectional 2D mesh (no wraparound) — the paper's main scalability target."""
    topo = Topology(f"mesh2d_{rows}x{cols}")
    topo.add_npus(rows * cols)
    idx = lambda r, c: r * cols + c
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                topo.add_bidir_link(idx(r, c), idx(r, c + 1), alpha, beta)
            if r + 1 < rows:
                topo.add_bidir_link(idx(r, c), idx(r + 1, c), alpha, beta)
    # mesh symmetries: row and column reflections (no wraparound -> no shifts)
    topo.automorphism_generators = [
        tuple(idx(rows - 1 - r, c) for r in range(rows) for c in range(cols)),
        tuple(idx(r, cols - 1 - c) for r in range(rows) for c in range(cols)),
    ]
    return topo


def torus2d(rows: int, cols: int, alpha: float = 0.0, beta: float = 1.0) -> Topology:
    """Bidirectional 2D torus (mesh + wraparound), the TPU pod abstraction."""
    topo = Topology(f"torus2d_{rows}x{cols}")
    topo.add_npus(rows * cols)
    idx = lambda r, c: r * cols + c
    for r in range(rows):
        for c in range(cols):
            topo.add_bidir_link(idx(r, c), idx(r, (c + 1) % cols), alpha, beta)
            topo.add_bidir_link(idx(r, c), idx((r + 1) % rows, c), alpha, beta)
    # torus symmetries: cyclic row/column translations (every row of a mesh
    # of process groups is isomorphic to every other row through these)
    topo.automorphism_generators = [
        tuple(idx((r + 1) % rows, c) for r in range(rows) for c in range(cols)),
        tuple(idx(r, (c + 1) % cols) for r in range(rows) for c in range(cols)),
    ]
    return topo


def torus3d(x: int, y: int, z: int, alpha: float = 0.0, beta: float = 1.0) -> Topology:
    topo = Topology(f"torus3d_{x}x{y}x{z}")
    topo.add_npus(x * y * z)
    idx = lambda i, j, k: (i * y + j) * z + k
    for i in range(x):
        for j in range(y):
            for k in range(z):
                topo.add_bidir_link(idx(i, j, k), idx((i + 1) % x, j, k), alpha, beta)
                topo.add_bidir_link(idx(i, j, k), idx(i, (j + 1) % y, k), alpha, beta)
                topo.add_bidir_link(idx(i, j, k), idx(i, j, (k + 1) % z), alpha, beta)
    iters = [(i, j, k) for i in range(x) for j in range(y) for k in range(z)]
    topo.automorphism_generators = [
        tuple(idx((i + 1) % x, j, k) for i, j, k in iters),
        tuple(idx(i, (j + 1) % y, k) for i, j, k in iters),
        tuple(idx(i, j, (k + 1) % z) for i, j, k in iters),
    ]
    return topo


def hypercube(dims: int, alpha: float = 0.0, beta: float = 1.0) -> Topology:
    """dims-dimensional binary hypercube: 2**dims NPUs; paper uses '3D Hypercube'
    meaning the generalization with side>2 — see :func:`grid_hypercube`."""
    n = 1 << dims
    topo = Topology(f"hypercube{dims}d")
    topo.add_npus(n)
    for i in range(n):
        for b in range(dims):
            j = i ^ (1 << b)
            if j > i:
                topo.add_bidir_link(i, j, alpha, beta)
    # XOR translations generate a transitive symmetry group of size 2**dims
    topo.automorphism_generators = [
        tuple(i ^ (1 << b) for i in range(n)) for b in range(dims)
    ]
    return topo


def grid_hypercube(side: int, dims: int, alpha: float = 0.0, beta: float = 1.0) -> Topology:
    """'3D Hypercube' in the paper's sense = dims-dimensional torus with equal
    sides (side**dims NPUs). dims=3 gives the paper's 3D Hypercube.

    The fabric is partitioned into ``side`` pods along the first dimension
    (one (dims-1)-torus plane each); the wraparound dim-0 links are the
    boundary fabric, so hierarchical synthesis decomposes per-plane."""
    if dims == 3:
        t = torus3d(side, side, side, alpha, beta)
        t.name = f"hypercube3d_{side}"
    elif dims == 2:
        t = torus2d(side, side, alpha, beta)
        t.name = f"hypercube2d_{side}"
    else:
        raise ValueError(f"unsupported dims={dims}")
    plane = side ** (dims - 1)
    t.set_partition([n // plane for n in range(t.num_nodes)])
    return t


def star_switch(
    n: int,
    alpha: float = 0.0,
    beta: float = 1.0,
    buffer_limit: int | None = None,
    multicast: bool = True,
) -> Topology:
    """n NPUs hanging off one switch (explicit switch node, paper §4.7)."""
    topo = Topology(f"star_switch{n}")
    topo.add_npus(n)
    sw = topo.add_node(NodeType.SWITCH, buffer_limit=buffer_limit, multicast=multicast)
    for i in range(n):
        topo.add_bidir_link(i, sw, alpha, beta)
    # any rotation of the leaves fixes the star (switch stays put)
    topo.automorphism_generators = [tuple((i + 1) % n for i in range(n)) + (sw,)]
    return topo


def two_level_switch(
    num_nodes: int,
    npus_per_node: int = 8,
    local_alpha: float = 0.5,
    local_beta: float = 1.0 / 400.0,  # ~400 GB/s scale-up per us-per-KiB scaling
    spine_alpha: float = 2.0,
    spine_beta: float = 1.0 / 50.0,  # ~50 GB/s scale-out
    buffer_limit: int | None = None,
    multicast: bool = True,
) -> Topology:
    """Heterogeneous 2D switch topology of paper Fig. 13: nodes of 8 NPUs with
    a fast local switch, node switches joined by a slower spine switch."""
    topo = Topology(f"switch2d_{num_nodes}x{npus_per_node}")
    topo.add_npus(num_nodes * npus_per_node)
    local = [
        topo.add_node(NodeType.SWITCH, buffer_limit=buffer_limit, multicast=multicast)
        for _ in range(num_nodes)
    ]
    spine = topo.add_node(NodeType.SWITCH, buffer_limit=buffer_limit, multicast=multicast)
    for node in range(num_nodes):
        for j in range(npus_per_node):
            topo.add_bidir_link(node * npus_per_node + j, local[node], local_alpha, local_beta)
        topo.add_bidir_link(local[node], spine, spine_alpha, spine_beta)
    # pods = {node's NPUs + its local switch}; the spine is shared (-1)
    pod_of = [i // npus_per_node for i in range(num_nodes * npus_per_node)]
    pod_of += list(range(num_nodes)) + [-1]
    topo.set_partition(pod_of)
    return topo


def tpu_v5e_pod(rows: int = 16, cols: int = 16, link_gbps: float = 50.0) -> Topology:
    """One TPU-v5e-like pod: 2D torus with ~50 GB/s/direction ICI links.

    beta is expressed in us per MiB so synthesized schedule times are in us
    for MiB-sized chunks: 1 MiB / (50 GB/s) = ~20 us/MiB.
    """
    beta_us_per_mib = (1.0 / (link_gbps * 1e9)) * (1 << 20) * 1e6
    t = torus2d(rows, cols, alpha=1.0, beta=beta_us_per_mib)
    t.name = f"tpu_v5e_pod_{rows}x{cols}"
    return t


def multi_pod(
    num_pods: int = 2,
    rows: int = 16,
    cols: int = 16,
    link_gbps: float = 50.0,
    dci_gbps: float = 25.0,
    dci_alpha: float = 10.0,
    dci_ports_per_pod: int = 16,
    unit_links: bool = False,
    dci_port_gbps: Sequence[float] | None = None,
    dci_ports_by_pod: Sequence[int] | None = None,
) -> Topology:
    """num_pods TPU pods; pod edge devices uplink to a DCI switch.

    NPU ids: pod p occupies [p*rows*cols, (p+1)*rows*cols). A single switch
    models the inter-pod fabric; each pod contributes `dci_ports_per_pod`
    uplinks from its first row (the 'edge' row). The partition (pod per
    torus, DCI switch shared) is set automatically, so hierarchical
    synthesis applies out of the box.

    Asymmetric-DCI variants (the traffic-engineering benchmark fabrics):

    * ``dci_port_gbps`` — per-uplink bandwidths in GB/s; uplink ``c`` of
      every pod runs at ``dci_port_gbps[c]`` (same profile per pod, so the
      pods stay isomorphic while their uplinks are mutually heterogeneous).
      When given it also sets the uplink count, overriding
      ``dci_ports_per_pod``.
    * ``dci_ports_by_pod`` — per-pod uplink *counts* (length
      ``num_pods``), for skewed-degree fabrics.

    ``unit_links=True`` collapses every link to (alpha=0, beta=1) — the
    paper's homogeneous unit-time regime — so the integer TEN fast path
    drives all phases; used by the scale benchmarks. It is incompatible
    with ``dci_port_gbps`` (unit links are uniform by definition).
    """
    if dci_port_gbps is not None:
        if unit_links:
            raise ValueError(
                "dci_port_gbps is incompatible with unit_links=True")
        dci_port_gbps = [float(g) for g in dci_port_gbps]
        if not dci_port_gbps or min(dci_port_gbps) <= 0:
            raise ValueError("dci_port_gbps must be non-empty positives")
    if dci_ports_by_pod is not None:
        dci_ports_by_pod = [int(k) for k in dci_ports_by_pod]
        if len(dci_ports_by_pod) != num_pods:
            raise ValueError(
                f"dci_ports_by_pod needs {num_pods} entries, got "
                f"{len(dci_ports_by_pod)}")
        if min(dci_ports_by_pod) < 1:
            raise ValueError("every pod needs >= 1 DCI uplink")
    beta_ici = (1.0 / (link_gbps * 1e9)) * (1 << 20) * 1e6
    beta_dci = (1.0 / (dci_gbps * 1e9)) * (1 << 20) * 1e6
    alpha_ici, alpha_dci = 1.0, dci_alpha
    if unit_links:
        alpha_ici = alpha_dci = 0.0
        beta_ici = beta_dci = 1.0
    suffix = "_unit" if unit_links else ""
    if dci_port_gbps is not None or dci_ports_by_pod is not None:
        suffix += "_asym"
    topo = Topology(f"multi_pod_{num_pods}x{rows}x{cols}{suffix}")
    per_pod = rows * cols
    topo.add_npus(num_pods * per_pod)
    idx = lambda p, r, c: p * per_pod + r * cols + c
    for p in range(num_pods):
        for r in range(rows):
            for c in range(cols):
                topo.add_bidir_link(idx(p, r, c), idx(p, r, (c + 1) % cols), alpha_ici, beta_ici)
                topo.add_bidir_link(idx(p, r, c), idx(p, (r + 1) % rows, c), alpha_ici, beta_ici)
    dci = topo.add_node(NodeType.SWITCH, buffer_limit=None, multicast=True)
    base_ports = (len(dci_port_gbps) if dci_port_gbps is not None
                  else dci_ports_per_pod)
    for p in range(num_pods):
        ports = dci_ports_by_pod[p] if dci_ports_by_pod is not None \
            else base_ports
        for c in range(min(ports, cols)):
            if dci_port_gbps is not None:
                gbps = dci_port_gbps[c % len(dci_port_gbps)]
                beta_c = (1.0 / (gbps * 1e9)) * (1 << 20) * 1e6
            else:
                beta_c = beta_dci
            topo.add_bidir_link(idx(p, 0, c), dci, alpha_dci, beta_c)
    topo.set_partition(
        [n // per_pod for n in range(num_pods * per_pod)] + [-1]
    )
    return topo


def three_level(
    num_pods: int = 2,
    racks_per_pod: int = 2,
    npus_per_rack: int = 4,
    rack_gbps: float = 400.0,
    agg_gbps: float = 100.0,
    dci_gbps: float = 25.0,
    dci_alpha: float = 10.0,
    dci_ports_per_pod: int | None = None,
    unit_links: bool = False,
    dci_port_gbps: Sequence[float] | None = None,
) -> Topology:
    """Three-level datacenter fabric: racks of NPUs, pods of racks, and a
    DCI plane of pods — the pods-of-pods regime where flat TEN search is
    hopeless and even one partition level leaves per-pod sub-problems too
    large.

    ``dci_port_gbps`` gives per-uplink DCI bandwidths (GB/s): the rack-``r``
    uplink of every pod runs at ``dci_port_gbps[r]`` — the same profile per
    pod, so pods stay isomorphic (pod rotation remains an automorphism)
    while the DCI plane is heterogeneous. Sets the uplink count when
    ``dci_ports_per_pod`` is not given; incompatible with ``unit_links``.

    Structure (NPU ids dense first: pod p, rack r, slot i at
    ``(p*R + r)*K + i``):

    * **rack**: ``npus_per_rack`` NPUs on a bidirectional ring (scale-up
      fabric); NPU 0 is the rack gateway.
    * **pod**: ``racks_per_pod`` racks; each rack gateway uplinks to the
      pod's aggregation switch (scale-out fabric).
    * **plane**: the first ``dci_ports_per_pod`` rack gateways of every pod
      uplink to a shared DCI switch (default: every rack gateway).

    The nested partition is derived automatically: NPU (p, r, i) carries
    path ``(p, r)``, the pod aggregation switches ``(p, -1)`` (inside their
    pod, shared across its racks), and the DCI switch ``-1`` — so
    ``pod_subtopology(p)`` is itself partitioned into racks and
    hierarchical synthesis recurses rack -> pod -> plane.

    ``unit_links=True`` collapses every link to (alpha=0, beta=1) — the
    homogeneous unit-time regime driving the integer-TEN fast paths; used
    by the scale benchmarks.
    """
    if npus_per_rack < 1 or racks_per_pod < 1 or num_pods < 1:
        raise ValueError("three_level sizes must be >= 1")
    if dci_ports_per_pod is not None and dci_ports_per_pod < 1:
        raise ValueError(
            "dci_ports_per_pod must be >= 1 (0 would disconnect the pods)")
    if dci_port_gbps is not None:
        if unit_links:
            raise ValueError(
                "dci_port_gbps is incompatible with unit_links=True")
        dci_port_gbps = [float(g) for g in dci_port_gbps]
        if not dci_port_gbps or min(dci_port_gbps) <= 0:
            raise ValueError("dci_port_gbps must be non-empty positives")
        if dci_ports_per_pod is None:
            dci_ports_per_pod = len(dci_port_gbps)
    ports = racks_per_pod if dci_ports_per_pod is None else min(
        dci_ports_per_pod, racks_per_pod)
    beta_rack = (1.0 / (rack_gbps * 1e9)) * (1 << 20) * 1e6
    beta_agg = (1.0 / (agg_gbps * 1e9)) * (1 << 20) * 1e6
    beta_dci = (1.0 / (dci_gbps * 1e9)) * (1 << 20) * 1e6
    alpha_rack, alpha_agg, alpha_dci = 0.5, 1.0, dci_alpha
    if unit_links:
        alpha_rack = alpha_agg = alpha_dci = 0.0
        beta_rack = beta_agg = beta_dci = 1.0
    suffix = "_unit" if unit_links else ""
    topo = Topology(
        f"three_level_{num_pods}x{racks_per_pod}x{npus_per_rack}{suffix}")
    per_rack, per_pod = npus_per_rack, racks_per_pod * npus_per_rack
    topo.add_npus(num_pods * per_pod)
    nid = lambda p, r, i: (p * racks_per_pod + r) * per_rack + i
    for p in range(num_pods):
        for r in range(racks_per_pod):
            if per_rack == 2:
                topo.add_bidir_link(nid(p, r, 0), nid(p, r, 1),
                                    alpha_rack, beta_rack)
            elif per_rack > 2:
                for i in range(per_rack):
                    topo.add_bidir_link(nid(p, r, i),
                                        nid(p, r, (i + 1) % per_rack),
                                        alpha_rack, beta_rack)
    agg = [topo.add_node(NodeType.SWITCH) for _ in range(num_pods)]
    for p in range(num_pods):
        for r in range(racks_per_pod):
            topo.add_bidir_link(nid(p, r, 0), agg[p], alpha_agg, beta_agg)
    dci = topo.add_node(NodeType.SWITCH)
    for p in range(num_pods):
        for r in range(ports):
            beta_r = beta_dci
            if dci_port_gbps is not None:
                gbps = dci_port_gbps[r % len(dci_port_gbps)]
                beta_r = (1.0 / (gbps * 1e9)) * (1 << 20) * 1e6
            topo.add_bidir_link(nid(p, r, 0), dci, alpha_dci, beta_r)
    paths: list = [
        (n // per_pod, (n % per_pod) // per_rack)
        for n in range(num_pods * per_pod)
    ]
    paths += [(p, -1) for p in range(num_pods)] + [-1]
    topo.set_partition(paths)
    # pod rotation is always a symmetry; rack rotation within every pod is
    # one exactly when every rack uplinks to the DCI (the registry verifies
    # each generator before use, so this only ever *adds* cache sharing)
    n_npus = num_pods * per_pod
    pod_rot = tuple(
        (n + per_pod) % n_npus for n in range(n_npus)
    ) + tuple(n_npus + (p + 1) % num_pods
              for p in range(num_pods)) + (dci,)
    topo.automorphism_generators = [pod_rot]
    # ... and only when the uplinks are mutually uniform: with per-port
    # DCI bandwidths, rotating racks would map a fast uplink onto a slow one
    uniform_ports = dci_port_gbps is None or len(
        {dci_port_gbps[r % len(dci_port_gbps)] for r in range(ports)}) == 1
    if ports == racks_per_pod and uniform_ports:
        rack_rot = tuple(
            (n // per_pod) * per_pod + (n % per_pod + per_rack) % per_pod
            for n in range(n_npus)
        ) + tuple(agg) + (dci,)
        topo.automorphism_generators.append(rack_rot)
    return topo
