"""Paper Fig. 15 reproduction on the production pod topology: two process
groups running DIFFERENT collectives (All-to-Allv + All-Gather) are jointly
synthesized over one shared TEN; NPUs outside both groups forward traffic.
The port of ``examples/synthesize_pod.py``, on the planner copy; it prints
the same lines.

    PYTHONPATH=src python -m repro_torch.examples.synthesize_pod

This is the *joint* synthesis layer: condition constructors (``all_gather``,
``all_to_allv``, ...) compose several groups' requirements into one
synthesis problem. A single collective goes through the
:class:`repro_torch.core.CollectiveRequest` entry point instead -- see
``repro_torch.examples.quickstart``.
"""

from __future__ import annotations

from repro_torch.core import (
    ChunkIds,
    all_gather,
    all_to_all,
    all_to_allv,
    replay_algorithm,
    synthesize_joint,
)
from repro_torch.topology import mesh2d, tpu_v5e_pod


def main() -> int:
    # paper setup: 3x3 mesh; NPUs 0-2 run All-to-Allv (NPU 0 sends 2x),
    # NPUs 6-8 run All-Gather; NPUs 3-5 belong to no group. The two groups'
    # conditions draw from one ChunkIds.split() family, so ids can't collide
    # even though each constructor gets its own allocator.
    topo = mesh2d(3, 3)
    v_ids, ag_ids = ChunkIds().split(2)
    v = all_to_allv([0, 1, 2], [[0, 2, 2], [1, 0, 1], [1, 1, 0]], ids=v_ids)
    ag = all_gather([6, 7, 8], ids=ag_ids, chunks_per_npu=2)
    alg = synthesize_joint(topo, [("a2av", v), ("allgather", ag)])
    alg.validate()
    used = {t.src for t in alg.transfers} | {t.dst for t in alg.transfers}
    outside = sorted(used - {0, 1, 2, 6, 7, 8})
    print("Fig 15 scenario on 3x3 mesh:")
    print(f"  makespan={alg.makespan}, transfers={alg.num_transfers}")
    print(f"  out-of-group NPUs carrying traffic: {outside}")
    util = replay_algorithm(alg).link_utilization()
    print(f"  links used: {len(util)}/{topo.num_links}")

    # same idea at pod scale: every row of an 8x8 pod slice runs its own
    # expert-parallel All-to-All (the MoE pattern), synthesized jointly
    pod = tpu_v5e_pod(8, 8)
    groups = []
    for r, row_ids in enumerate(ChunkIds().split(8)):
        row = [r * 8 + c for c in range(8)]
        groups.append((f"ep_row{r}", all_to_all(row, ids=row_ids, bytes=1.0)))
    alg = synthesize_joint(pod, groups)
    alg.validate()
    print("\n8x8 pod, 8 concurrent EP All-to-All groups:")
    print(f"  makespan={alg.makespan:.1f} us, transfers={alg.num_transfers}")
    print(f"  links used: {len(alg.link_busy_time())}/{pod.num_links}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
