"""Production training launcher, ported from ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 20 \\
        --device cpu                      # the CPU smoke run
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20                        # one card, train_4k's batch
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --reduced --steps 20              # four cards, model = 4

The launcher wires the production pieces together, as the reference's:
the process group and the mesh (1, n) on ("data", "model") over its n
ranks (``launch.mesh.launch_group``), ``ShardingPolicy`` with
``pad_heads``, ``LM(policy=, remat=True)`` on DTensor, f32 params and
AdamW on the reference's cosine schedule, the deterministic
``DataPipeline``, the async ``Checkpointer`` and the straggler monitor.
Each step differentiates ``lm.loss`` at the f32 params, as the reference's
jitted step does (and ``train_lm``'s ``Trainer.step``).

Checkpoints: after the update with batch s, where s is a nonzero multiple
of 10, the state is saved under label s + 1: label k holds k updates.
``--resume`` restores the newest label k onto the current mesh (the
template is the state just initialized there, so a checkpoint saved at one
mesh size resumes at another) and runs from batch k, so a resumed run takes
the steps an uninterrupted one would. (The reference saves that state
under label s and resumes at batch s, so its resumed run applies batch s
twice; ROADMAP §3.)

``--dry-run`` runs the production cell (``--arch``, ``--shape``,
``--mesh``) through the port's dry run, ``launch/dryrun.py``, in a child
process, as the reference hands off to its own: the dry run's fake process
group of 256 or 512 ranks cannot share a process with a launch group.
``--mesh`` is read only there.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --dry-run --mesh multipod         # fake CUDA tensors: a CUDA torch
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.bridge import named_leaves
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import launch_group
from repro_torch.launch.sharding import ShardingPolicy, pad_heads
from repro_torch.launch.train_lm import clone_params, loss_and_grads
from repro_torch.models import LM
from repro_torch.models.layers import Params
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime import StragglerMonitor
from repro_torch.runtime.fault_tolerance import StepTimer

REDUCED_SHAPE = ShapeSpec("reduced", 256, 8, "train")  # --reduced: 8 x 256
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_launch_ckpt")


def _full(x) -> float:
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def train(cfg: ModelConfig, shape: str | ShapeSpec, *, steps: int, ckpt_dir: str,
          resume: bool = False, device=None, params: Params | None = None, seed: int = 0,
          log=print) -> dict:
    """Train ``cfg`` on ``shape``'s batch (a ``SHAPES`` name or a
    ``ShapeSpec``) up to batch ``steps``, on the launch group's mesh.
    ``params`` (a plain tree, f32; copied, so the caller's stay as they
    are) replace ``LM.init(seed)``; ``resume`` first restores the newest
    label in ``ckpt_dir``. The first rank alone logs. Returns each step's
    loss, gradient norm, seconds and straggler verdict, the batch the run
    started at, the mesh, and the final params and AdamW state (DTensors
    on it)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    with launch_group(device) as (mesh, dev):
        say = log if dist.get_rank() == 0 else (lambda line: None)
        policy = ShardingPolicy(mesh, cfg)
        cfg = pad_heads(cfg, policy.tp_size)
        policy.cfg = cfg
        lm = LM(cfg, ep_degree=policy.tp_size, device=dev, policy=policy, remat=True)
        say(f"arch={cfg.name} ({cfg.param_count() / 1e6:.1f}M params) "
            f"mesh={mesh.axis_sizes}")
        if params is None:
            params = lm.init(seed, param_dtype=torch.float32)
        else:
            params = policy.param_shardings(clone_params(params))
        opt = adamw_init(params)
        lr = cosine_schedule(3e-4, warmup=max(steps // 10, 1), total=max(steps, 100))
        ck = Checkpointer(ckpt_dir, keep=2)
        start = 0
        if resume and ck.latest_step() is not None:
            start, state = ck.restore({"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            say(f"resumed at step {start}")
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        pipe = DataPipeline(seed=0, batch=shape.global_batch, seq=shape.seq_len,
                            vocab=cfg.vocab_size, start_step=start, device=dev)
        monitor = StragglerMonitor()
        out = {"loss": [], "grad_norm": [], "step_s": [], "verdict": [], "start_step": start}
        try:
            for _ in range(start, steps):
                step, batch = next(pipe)
                with StepTimer(monitor) as timer:
                    t0 = time.perf_counter()
                    loss, grads = loss_and_grads(lm, params, batch)
                    _, _, metrics = adamw_update(params, grads, opt, lr=lr)
                    del grads
                    loss, gnorm = float(loss), _full(metrics["grad_norm"])  # synchronizes
                    out["step_s"].append(time.perf_counter() - t0)
                out["loss"].append(loss)
                out["grad_norm"].append(gnorm)
                out["verdict"].append(timer.verdict)
                if timer.verdict != "ok":
                    say(f"  [straggler] step {step}: {timer.verdict}")
                if step % 5 == 0 or step == steps - 1:
                    say(f"step {step:4d} loss={loss:.4f} gnorm={gnorm:.2f}")
                if step and step % 10 == 0:
                    ck.save(step + 1, {"params": params, "opt": opt})
        finally:
            pipe.close()
            ck.close()
        say("done")
    return {**out, "params": params, "opt": opt, "mesh": mesh}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--reduced", action="store_true",
                    help="the small same-family config at 8 x 256 (CPU smoke runs)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"],
                    help="the production mesh of --dry-run")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the full cell on fake tensors (launch/dryrun.py), no step")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch.dryrun import in_child

        return in_child(args.arch, args.shape, args.mesh, args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(cfg, REDUCED_SHAPE if args.reduced else args.shape, steps=args.steps,
          ckpt_dir=args.ckpt_dir, resume=args.resume, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
