"""The dry run's cases that need a fake process group, run in a process of
their own by ``tests/test_torch_dryrun.py`` (the default group is
process-wide, and a fake one would leak into the other tests):

    python tests/_torch_dryrun_worker.py OUT.json

Groups of 4, 2, 1 and then 256 ranks, one after another
(``dryrun.fake_group`` ends each before the next): a DTensor all-gather and
all-reduce counted by ``op_cost.analyze``; a Megatron MLP block and the
reduced llama3.2-1b prefill at tp 2 against tp 1, counted per device and
by the planted global-shape counter (``FlopCounterMode``, which sits above
DTensor); the argument bytes of all 40 cells placed on the pod mesh; and
``run_cell`` of llama3.2-1b's decode_32k and long_500k cells there, and
the command line of that cell twice (the second from its cache). Writes
every number to OUT.json.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import REGISTRY, SHAPES, ShapeSpec
from repro_torch.launch import dryrun, op_cost, steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh

GEMMS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")
MLP = (8, 64, 256)  # tokens, d, hidden
PREFILL = ShapeSpec("prefill_reduced", 32, 2, "prefill")


def gemm_flops(cost) -> float:
    return sum(v for k, v in cost.flops_by_op.items() if k in GEMMS)


def collectives() -> dict:
    """On 4 ranks: a [16, 32] f32 tensor split on rows gathered whole (the
    all-gather's result is the whole 2 KiB), and a Partial [8, 8] f32 sum
    (the all-reduce's result is the 256 B tensor)."""
    dryrun.fake_group(4)
    mesh = make_mesh((4,), ("model",), device_type="cpu").device_mesh
    x = distribute_tensor(torch.randn(16, 32), mesh, [Shard(0)])
    _, gather = op_cost.analyze(lambda t: t.redistribute(mesh, [Replicate()]).to_local(), x)
    from torch.distributed.tensor import DTensor, Partial

    y = DTensor.from_local(torch.randn(8, 8), mesh, [Partial()], run_check=False)
    _, reduce = op_cost.analyze(lambda t: t.redistribute(mesh, [Replicate()]).to_local(), y)
    return {"gather": [gather.collective_bytes, gather.collective_counts],
            "reduce": [reduce.collective_bytes, reduce.collective_counts]}


def mlp_block(tp: int) -> dict:
    """x [T, d] replicated, W1 [d, h] split on columns, W2 [h, d] on rows,
    over a (1, tp) mesh: silu(x W1) W2, its partial sums reduced. GEMM
    FLOPs per device from ``op_cost`` and from ``FlopCounterMode``."""
    dryrun.fake_group(tp)
    mesh = make_mesh((1, tp), ("data", "model"), device_type="cpu").device_mesh
    T, d, h = MLP
    gen = torch.Generator().manual_seed(0)
    x = distribute_tensor(torch.randn(T, d, generator=gen), mesh, [Replicate(), Replicate()])
    w1 = distribute_tensor(torch.randn(d, h, generator=gen), mesh, [Replicate(), Shard(1)])
    w2 = distribute_tensor(torch.randn(h, d, generator=gen), mesh, [Replicate(), Shard(0)])

    def block(x, w1, w2):
        return (torch.nn.functional.silu(x @ w1) @ w2).redistribute(
            mesh, [Replicate(), Replicate()])

    _, cost = op_cost.analyze(block, x, w1, w2)
    with FlopCounterMode(display=False) as counter:
        block(x, w1, w2)
    return {"op_cost": gemm_flops(cost), "global": counter.get_total_flops(),
            "all-reduce": cost.collective_counts.get("all-reduce", 0)}


def llama_prefill(tp: int) -> dict:
    """The reduced llama3.2-1b's prefill bundle on a (1, tp) mesh, on
    fake tensors as ``run_cell`` runs it: its GEMM FLOPs per device."""
    dryrun.fake_group(tp)
    mesh = make_mesh((1, tp), ("data", "model"), device_type="cpu")
    rec = dryrun.run_cell("llama3.2-1b", PREFILL, f"1x{tp}", mesh)
    return {"status": rec["status"], "flops": rec.get("flops"),
            "gemm": rec.get("flops_by_op", {}), "error": rec.get("error")}


def pod_cells() -> dict:
    """Every cell's arguments placed on the pod mesh (no step run), and
    ``run_cell`` of llama3.2-1b's decode_32k and long_500k."""
    dryrun.fake_group(256)
    mesh = make_production_mesh(device_type="cpu")
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh.device_mesh
    placed = {}
    for arch in sorted(REGISTRY):
        for shape in SHAPES:
            bundle = steps.build_bundle(arch, shape, mesh)
            with FakeTensorMode(allow_non_fake_inputs=True):
                args = dryrun.place_args(bundle, torch.device("cpu"))
                placed[f"{arch}|{shape}"] = dryrun.storage_bytes(op_cost.local_tensors(args))
    cells = {s: dryrun.run_cell("llama3.2-1b", s, "pod", mesh)
             for s in ("decode_32k", "long_500k")}
    with tempfile.TemporaryDirectory() as where:
        out = os.path.join(where, "dryrun.json")
        argv = ["--device", "cpu", "--arch", "llama3.2-1b", "--shape", "decode_32k",
                "--mesh", "pod", "--out", out]
        rc = [dryrun.main(argv), dryrun.main(argv)]  # the second reads the cache
        with open(out) as f:
            cached = json.load(f)
    cli = {"rc": rc, "status": cached["llama3.2-1b|decode_32k|pod"]["status"]}
    return {"argument_bytes": placed, "cells": cells, "cli": cli}


def main(out: str) -> None:
    torch.set_num_threads(1)
    result = {"collectives": collectives(),
              "mlp": {tp: mlp_block(tp) for tp in (1, 2)},
              "prefill": {tp: llama_prefill(tp) for tp in (1, 2)},
              "pod": pod_cells()}
    with open(out, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1])
