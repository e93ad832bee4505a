"""Quickstart: synthesize a topology-aware, process-group-aware collective.
The port of ``examples/quickstart.py``, on the planner copy and the stacked
executor.

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Builds a 4x4 mesh, synthesizes an All-Gather for a 3-NPU process group and
an All-to-All for the whole mesh through the :class:`CollectiveRequest`
API, validates both, compares against the Direct baseline, prints the
ppermute translation, *executes* the process-group All-Gather on 16 ranks,
one per NPU, held in one tensor on the device (the stacked backend: where
the reference runs one process over a 16-device jax mesh), and finishes
with a fault drill: a link dies and the plan is repaired incrementally
instead of re-synthesized from scratch. Every line but the execution's
wording equals the reference's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.comms import pccl_all_gather
from repro_torch.core import (
    AlgorithmRegistry,
    CollectiveRequest,
    DegradationEvent,
    PlanRepairer,
    SynthesisEngine,
    direct_all_to_all,
    to_msccl_json,
    to_ppermute_program,
)
from repro_torch.device import resolve_device
from repro_torch.topology import mesh2d, multi_pod

GROUP = (0, 3, 12)  # the corners of the 4x4 mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    topo = mesh2d(4, 4)
    eng = SynthesisEngine(topo)
    print(f"topology: {topo}")

    # --- process-group All-Gather: corners only ---
    # one request object carries the whole collective spec (kind, group,
    # payload, chunking, routing) — the same value keys the plan registry
    req = CollectiveRequest("all_gather", group=GROUP)
    alg = eng.collective(req)
    alg.validate()
    used = {t.src for t in alg.transfers} | {t.dst for t in alg.transfers}
    print(f"\nAll-Gather over process group {list(req.group)}:")
    print(f"  makespan={alg.makespan} steps, transfers={alg.num_transfers}")
    print(f"  NPUs touched: {sorted(used)} (out-of-group forwarding: "
          f"{sorted(used - set(req.group))})")
    for t in alg.transfers[:6]:
        print(f"    t={t.start:>4}: chunk {t.chunk} {t.src} -> {t.dst}")

    # --- whole-mesh All-to-All vs Direct ---
    full = tuple(range(16))
    a2a = eng.collective(CollectiveRequest("all_to_all", group=full))
    a2a.validate()
    direct = direct_all_to_all(topo, list(full))
    print("\nAll-to-All over all 16 NPUs:")
    print(f"  PCCL makespan   = {a2a.makespan}")
    print(f"  Direct makespan = {direct.makespan}")
    print(f"  speedup         = {direct.makespan / a2a.makespan:.2f}x")

    # --- translations ---
    prog = to_ppermute_program(a2a)
    print(f"\nppermute program: {prog.num_rounds} rounds "
          f"({sum(len(r) for r in prog.rounds)} sends)")
    print("first round:", [(s.src, s.dst) for s in prog.rounds[0]][:8], "...")
    ir = to_msccl_json(alg)
    print(f"\nMSCCL-IR export: {len(ir)} bytes of JSON (alg 'pccl_all_gather')")

    # --- execute the process-group All-Gather, every NPU a stacked rank ---
    # the same request lowers to rounds of sends; out-of-group NPUs forward
    # chunks in transit but return zeros
    n = len(topo.npus)
    x = (torch.arange(n, dtype=torch.float32, device=device) + 1.0)[:, None]  # NPU d holds d+1
    out = pccl_all_gather(x, topo, req).cpu()  # [n, group_size, 1]
    m = req.group[0]
    print(f"\nexecuted on {n} stacked ranks on {device}: NPU {m} gathered "
          f"{out[m, :, 0].tolist()} (group {list(req.group)}), "
          f"non-member NPU 1 got {out[1, :, 0].tolist()}")

    # --- degraded-fabric repair ---
    # plan a pod-spanning All-Gather with phase capture, kill one
    # pod-internal link, and patch only the damaged pod's phases; the
    # undamaged pods' schedules survive verbatim
    pods = multi_pod(4, 4, 4, unit_links=True)
    rp = PlanRepairer(pods, registry=AlgorithmRegistry(), pipeline=False)
    preq = CollectiveRequest("all_gather", group=tuple(pods.npus))
    rp.plan(preq)
    victim = next(
        l.id for l in pods.links
        if l.id not in {b.id for b in pods.boundary_links()})
    res = rp.repair(preq, DegradationEvent(failed_links=[victim]))
    res.algorithm.validate()
    print(f"\nlink {victim} died on {pods.name}: strategy={res.strategy}, "
          f"{res.phases_kept} phases kept verbatim, "
          f"{res.phases_resynthesized} re-synthesized")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
