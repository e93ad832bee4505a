"""One rank of the port's data-parallel training test, started by
``torch.multiprocessing`` from ``tests/test_torch_train.py``.

Imports torch, numpy and the port only (no jax). Every rank trains the tiny
model through ``DistBackend`` (PCCL) and ``dist.all_reduce`` (built-in)
side by side on its rows of each global batch, and saves its losses and
its final params for the parent to compare.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

STEPS, BATCH, SEQ = 2, 8, 32


def config():
    from repro_torch.launch import train_lm

    return dataclasses.replace(train_lm.model_config("tiny"), dtype="float32")


def initial_params():
    """The same params in every process: the port's seeded init, f32."""
    from repro_torch.models import LM

    return LM(config(), device="cpu").init(0, param_dtype=torch.float32)


def flat_params(trainer) -> np.ndarray:
    from repro_torch.bridge import named_leaves

    return np.concatenate([t.detach().reshape(-1).numpy()
                           for _, t in named_leaves(trainer.replicas[0])])


def run_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import train_lm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        lines = []
        out = train_lm.train(config(), steps=STEPS, batch=BATCH, seq=SEQ, dp=world,
                             compare=True, device="cpu", params=initial_params(),
                             log=lines.append)
        for name in train_lm.COLLECTIVES:
            np.save(Path(out_dir) / f"{name}.loss.{rank}.npy", np.array(out[name]["loss"]))
            np.save(Path(out_dir) / f"{name}.params.{rank}.npy", flat_params(out[name]["trainer"]))
        (Path(out_dir) / f"log.{rank}.txt").write_text("\n".join(lines))
    finally:
        dist.destroy_process_group()
