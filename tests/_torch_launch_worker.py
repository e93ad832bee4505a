"""Helpers of ``tests/test_torch_launch.py``.

* Run as a script, the reference's launcher with a recorder:

      python tests/_torch_launch_worker.py OUT_DIR CKPT_DIR

  runs ``repro.launch.train.main`` twice in this process, ``--reduced
  --steps 12`` and then the same with ``--resume``, on f32 (the module's
  ``get_config`` rebound to the config in f32) and writes to ``OUT_DIR``
  each step's loss and gradient norm at full precision, and the AdamW step
  each checkpoint label holds after each run (``steps.json``), and the
  params the first run started from (``init.npz``). The module's
  own ``jax`` name is rebound to a namespace whose ``jit`` records the
  step's inputs and outputs; no file of the reference changes. It needs
  its own environment (``PYTHONPATH=src``, ``JAX_PLATFORMS=cpu``, no
  ``XLA_FLAGS`` device count), so that ``jax.device_count()`` is 1.
* ``run_elastic_rank``: one of the spawned gloo ranks of the elastic case.
  Imports torch, numpy and the port only (no jax).
"""

from __future__ import annotations

import json
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

STEPS = 12  # the reference's run: a save at step 10
ELASTIC_STEPS = (22, 23)  # the two-rank run, then the resumed one-rank run
ELASTIC_BATCH, ELASTIC_SEQ = 4, 32


def reduced_f32(arch: str = "llama3.2-1b"):
    """The port's ``--reduced`` config in f32."""
    from repro_torch.configs import get_config

    return get_config(arch).reduced(dtype="float32")


def elastic_shape():
    from repro_torch.configs import ShapeSpec

    return ShapeSpec("elastic", ELASTIC_SEQ, ELASTIC_BATCH, "train")


def flat(tree, prefix: str = "") -> dict:
    """The leaves of a nested dict by their ``/``-joined path."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def nested(leaves: dict) -> dict:
    """The inverse of ``flat``."""
    out: dict = {}
    for key, v in leaves.items():
        *path, last = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


class RecordingJax:
    """``jax`` with a ``jit`` that records every call of the jitted train
    step: the params of the first call, and each call's loss and gradient
    norm (the step's outputs 2 and 3)."""

    def __init__(self, jax):
        self._jax = jax
        self.initial = None
        self.steps: list[tuple[float, float]] = []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn):
        jitted = self._jax.jit(fn)

        def step(params, opt, batch):
            if self.initial is None:
                self.initial = {k: np.asarray(v) for k, v in flat(params).items()}
            out = jitted(params, opt, batch)
            self.steps.append((float(out[2]), float(out[3])))
            return out

        return step


def reference_runs(out_dir: str, ckpt_dir: str) -> None:
    import dataclasses

    import jax

    from repro import configs
    from repro.launch import train as ref

    rec = RecordingJax(jax)
    ref.jax = rec
    ref.get_config = lambda arch: dataclasses.replace(configs.get_config(arch),
                                                      dtype="float32")
    runs, labels = {}, {}
    for name, extra in (("first", []), ("resumed", ["--resume"])):
        sys.argv = ["train", "--reduced", "--steps", str(STEPS), "--ckpt-dir", ckpt_dir,
                    *extra]
        before = len(rec.steps)
        ref.main()
        runs[name] = rec.steps[before:]
        labels[name] = {d: int(np.load(Path(ckpt_dir) / d / "opt.npz")[".step"])
                        for d in sorted(os.listdir(ckpt_dir))}
    runs["labels"] = labels
    out = Path(out_dir)
    np.savez(out / "init.npz", **rec.initial)
    (out / "steps.json").write_text(json.dumps({**runs, "devices": jax.device_count()}))


def run_elastic_rank(rank: int, world: int, init_file: str, ckpt_dir: str,
                     out_file: str) -> None:
    """Resume ``ckpt_dir``'s newest label on ``world`` gloo ranks (mesh 1 x
    world) and train to ``ELASTIC_STEPS[0]``; rank 0 saves the losses, the
    batch the run started at, and the lines it logged."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.train import train

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        lines: list[str] = []
        out = train(reduced_f32(), elastic_shape(), steps=ELASTIC_STEPS[0],
                    ckpt_dir=ckpt_dir, resume=True, device="cpu", log=lines.append)
        if rank == 0:
            np.savez(out_file, loss=np.array(out["loss"]), start=out["start_step"],
                     lines=np.array(lines), mesh=np.array(out["mesh"].shape))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    reference_runs(sys.argv[1], sys.argv[2])
