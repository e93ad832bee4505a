"""One rank of the port's data-parallel training tests, started by
``torch.multiprocessing`` from ``tests/test_torch_train.py`` and
``tests/test_torch_checkpoint.py``.

Imports torch, numpy and the port only (no jax). In ``run_rank`` every rank
trains the tiny model through ``DistBackend`` (PCCL) and ``dist.all_reduce``
(built-in) side by side on its rows of each global batch, and saves its
losses and its final params for the parent to compare. In
``run_ckpt_rank`` every rank trains uninterrupted, then stops after a
checkpoint and resumes from it, and saves what the parent compares.
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


def run_ckpt_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """Run U: 4 steps, checkpoints every 2 under ``u/``; run C: 3 steps under
    ``c/`` (label 2); run R: resumed from ``c/`` to 4 steps. Saves each run's
    losses, U's and R's final params, the labels this rank wrote in C and the
    label R restored."""
    import torch.distributed as dist

    from repro_torch.launch import train_lm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        def run(steps, sub, **kw):
            return train_lm.train(config(), steps=steps, batch=4, seq=16, dp=world,
                                  collectives="builtin", device="cpu", params=initial_params(),
                                  ckpt_dir=str(Path(out_dir) / sub), ckpt_every=2,
                                  log=lambda line: None, **kw)

        u, c, r = run(4, "u"), run(3, "c"), run(4, "c", resume=True)
        np.savez(Path(out_dir) / f"ckpt.{rank}.npz",
                 uninterrupted=np.array(u["builtin"]["loss"]),
                 stopped=np.array(c["builtin"]["loss"]), resumed=np.array(r["builtin"]["loss"]),
                 params_u=flat_params(u["builtin"]["trainer"]),
                 params_r=flat_params(r["builtin"]["trainer"]),
                 saves=np.array([s["step"] for s in c["builtin"]["saves"]], dtype=np.int64),
                 restored=np.array(r["builtin"]["restored"]["step"]))
    finally:
        dist.destroy_process_group()
