"""One rank of the port's ``DistBackend`` test, started by
``torch.multiprocessing`` from ``tests/test_torch_comms.py``.

Imports torch, numpy and the port only (no jax), so each of the eight
processes starts fast. Every rank runs every case (the ranks outside a
process group too, as they must) on its own shard of the stacked input,
and saves its outputs for the parent to compare.
"""

from __future__ import annotations

from datetime import timedelta
from pathlib import Path

import numpy as np
import torch


def cases():
    """name -> (collective, topology, spec, stacked input)."""
    from repro_torch.comms.primitives import CollectiveSpec
    from repro_torch.topology import line, ring

    rng = np.random.default_rng(5)
    return {
        "ring8_all_reduce": ("all_reduce", ring(8, bidirectional=True),
                             CollectiveSpec("all_reduce", tuple(range(8))),
                             rng.standard_normal((8, 8 * 6)).astype(np.float32)),
        "line8_all_gather": ("all_gather", line(8),
                             CollectiveSpec("all_gather", (0, 3, 7)),
                             rng.standard_normal((8, 5)).astype(np.float32)),
    }


def run_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.comms import primitives
    from repro_torch.comms.executor import DistBackend

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        backend = DistBackend()
        for name, (kind, topo, spec, x) in cases().items():
            fn = getattr(primitives, f"pccl_{kind}")
            got = fn(torch.from_numpy(x[rank].copy()), topo, spec, backend=backend)
            np.save(Path(out_dir) / f"{name}.{rank}.npy", got.numpy())
    finally:
        dist.destroy_process_group()
