"""Data-parallel training of a reduced llama3.2-1b with the gradient mean
taken by a PCCL-synthesized all-reduce: the port's counterpart of
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --model tiny --dp 8 \\
        --compare-collectives --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_lm --model 100m --dp 8 \\
        --steps 3 --compare-collectives          # on the card

Each step, every rank computes its loss and gradients on its rows of the
global batch (the attention through the flash kernels, forward and
backward). The gradients and the loss flatten into one f32 vector, padded
to a multiple of dp, which is all-reduced and divided by dp:
``--collectives pccl`` runs the plan of a bidirectional ring of dp ranks
that ``PlanService.program()`` serves through ``pccl_all_reduce``;
``builtin`` (the command's default, as the reference's is its framework
reduction) is ``x.sum(0)`` or ``dist.all_reduce``. AdamW then steps every
rank's replica of the params. ``--compare-collectives`` runs both from the
same params on the same batches and prints the largest divergence as
``PCCL_CONFORMANCE max_loss_diff=... max_param_diff=...``.

The ranks: with no ``torch.distributed`` group initialized, all dp ranks
live in this process. Each rank's gradient is computed in turn into its row
of a ``[dp, n]`` tensor, the stacked backend all-reduces it, every row must
come back equal, and every rank's params must stay equal bit for bit (each
step checks both). Under an initialized group (gloo on the CPU, NCCL on
cards) this process is one rank and the all-reduce goes through
``DistBackend``.

Checkpoints (``--ckpt-every``, ``--ckpt-dir``, ``--resume``; not with
``--compare-collectives``, as in the reference): the state after k updates,
the first rank's params and AdamW state, is saved under label k in the
background while training goes on, and holds AdamW step k. ``--resume``
restores the newest label and runs from step k, so a resumed run takes
the steps an uninterrupted one would, bit for bit. (The reference saves
the state after step k's update under label k and resumes at step k, so
its resumed run applies batch k twice; ROADMAP §3.) Under
``DistBackend`` the first rank alone writes, and every rank restores after
a barrier. Each step runs under the reference's straggler monitor.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.bridge import named_leaves
from repro_torch.checkpoint import Checkpointer
from repro_torch.comms.executor import STACKED, DistBackend
from repro_torch.comms.primitives import pccl_all_reduce
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.planservice import PlanService
from repro_torch.core.request import CollectiveRequest
from repro_torch.data.pipeline import DataPipeline, shard_batch
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.models.layers import Params
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime import StragglerMonitor
from repro_torch.runtime.fault_tolerance import StepTimer
from repro_torch.topology import ring

MODELS = {
    # tiny: mesh-conformance subprocess tests | ~10M: d=256, 4L
    # ~100M: d=768, 12L (GPT-2-small-ish)
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                 head_dim=32, d_ff=256, vocab_size=512),
    "10m": dict(num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
                head_dim=32, d_ff=1024, vocab_size=8192),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
                 head_dim=64, d_ff=3072, vocab_size=32000),
}
COLLECTIVES = ("pccl", "builtin")
DATA_SEED = 1234  # the reference's pipeline seed


def model_config(model: str) -> ModelConfig:
    """llama3.2-1b reduced to ``MODELS[model]`` (bf16, as the reference)."""
    return get_config("llama3.2-1b").reduced(**MODELS[model])


def _tree_like(like: Params, leaves) -> Params:
    """A tree shaped as ``like`` whose leaves are taken from the iterator
    ``leaves`` in ``named_leaves`` order."""
    if isinstance(like, dict):
        return {k: _tree_like(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def clone_params(params: Params) -> Params:
    return _tree_like(params, (t.detach().clone() for _, t in named_leaves(params)))


def clone_opt(opt: AdamWState) -> AdamWState:
    return AdamWState(opt.step, clone_params(opt.mu), clone_params(opt.nu))


def flatten(grads: Params, loss: torch.Tensor) -> torch.Tensor:
    """Every gradient leaf (``named_leaves`` order) and the loss, as one f32
    vector (train_lm.py:102-104)."""
    return torch.cat([g.reshape(-1).float() for _, g in named_leaves(grads)]
                     + [loss.detach().reshape(1).float()])


def unflatten(vec: torch.Tensor, like: Params) -> Params:
    """The inverse of ``flatten`` without the loss: views of ``vec`` shaped
    and typed as the leaves of ``like``."""
    sizes = [t.numel() for _, t in named_leaves(like)]
    parts = iter(vec.split(sizes))
    return _tree_like(like, (next(parts).view_as(t).to(t.dtype)
                             for _, t in named_leaves(like)))


def loss_and_grads(lm: LM, params: Params, batch: dict):
    """(loss, grads) of ``lm.loss`` at ``params`` (leaves that require grad)."""
    loss, _ = lm.loss(params, batch)
    leaves = [t for _, t in named_leaves(params)]
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _tree_like(params, iter(grads))


class GradientMean:
    """The mean over dp ranks of a flattened gradient vector: ``[dp, n]``
    stacked (every rank's row) or ``[n]`` (this rank's, under
    ``DistBackend``); padded to a multiple of dp for the all-reduce
    (train_lm.py:94-100). At dp=1 there is no collective, no plan and no
    ring: the vector is the mean as it is, as the reference's dp=1 step
    (train_lm.py:177-183) takes its gradient."""

    def __init__(self, dp: int, collectives: str, backend=STACKED):
        if collectives not in COLLECTIVES:
            raise ValueError(f"collectives {collectives!r} not in {COLLECTIVES}")
        self.dp, self.collectives, self.backend = dp, collectives, backend
        if collectives == "pccl" and dp > 1:
            self.topo = ring(dp, bidirectional=True)
            self.program = PlanService().program(self.topo, {"data": dp},
                                                 "all_reduce", "data")
            self.req = CollectiveRequest("all_reduce", group=tuple(range(dp)))

    def __call__(self, vec: torch.Tensor) -> torch.Tensor:
        if self.dp == 1:
            return vec
        pad = (-vec.shape[-1]) % self.dp
        if pad:
            vec = F.pad(vec, (0, pad))
        if self.collectives == "pccl":
            out = pccl_all_reduce(vec, self.topo, self.req, program=self.program,
                                  backend=self.backend)
        elif self.backend.rank is None:
            out = vec.sum(0, keepdim=True).expand_as(vec)
        else:
            out = vec.clone()
            dist.all_reduce(out)
        if pad:
            out = out[..., :-pad]
        return out / self.dp


class Trainer:
    """The replicas of one data-parallel run: dp of them stacked in this
    process, or this rank's alone under ``DistBackend``; each with its
    params (f32) and AdamW state, its own copies of ``params`` and ``opt``
    (default: a fresh state)."""

    def __init__(self, lm: LM, params: Params, dp: int, collectives: str, lr,
                 backend=STACKED, opt: AdamWState | None = None):
        self.lm, self.dp, self.lr = lm, dp, lr
        self.rank = backend.rank
        self.replicas = [clone_params(params) for _ in range(dp if self.rank is None else 1)]
        for rep in self.replicas:
            for _, t in named_leaves(rep):
                t.requires_grad_(True)
        self.opts = [adamw_init(rep) if opt is None else clone_opt(opt)
                     for rep in self.replicas]
        self.mean = GradientMean(dp, collectives, backend)

    def step(self, batch: dict) -> tuple[float, float]:
        """One step on the global ``batch``: (mean loss, gradient norm)."""
        ranks = range(self.dp) if self.rank is None else [self.rank]
        rows = None
        for i, r in enumerate(ranks):
            loss, grads = loss_and_grads(self.lm, self.replicas[i],
                                         shard_batch(batch, r, self.dp))
            vec = flatten(grads, loss)
            del grads
            if rows is None:
                rows = torch.empty((len(ranks), vec.numel()), dtype=torch.float32,
                                   device=vec.device)
            rows[i] = vec
            del vec
        mean = self.mean(rows if self.rank is None else rows[0]).reshape(len(ranks), -1)
        del rows
        if not all(torch.equal(mean[i], mean[0]) for i in range(1, len(ranks))):
            raise RuntimeError("the all-reduce gave the ranks different vectors")
        gnorm = None
        for rep, opt, row in zip(self.replicas, self.opts, mean):
            _, _, metrics = adamw_update(rep, unflatten(row[:-1], rep), opt, lr=self.lr)
            gnorm = metrics["grad_norm"]
        if not self.replicas_equal():
            raise RuntimeError("the ranks' params differ after the step")
        return float(mean[0, -1]), float(gnorm)

    def replicas_equal(self) -> bool:
        """Whether every replica's params equal the first's bit for bit."""
        first = named_leaves(self.replicas[0])
        return all(torch.equal(a, b) for rep in self.replicas[1:]
                   for (_, a), (_, b) in zip(first, named_leaves(rep)))


def max_abs_diff(a: Params, b: Params) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for (_, x), (_, y) in zip(named_leaves(a), named_leaves(b)))


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, dp: int = 1,
          collectives: str = "pccl", compare: bool = False, device=None,
          seed: int = 0, params: Params | None = None, opt: AdamWState | None = None,
          ckpt_dir: str | None = None, ckpt_every: int = 10, resume: bool = False,
          log=print) -> dict:
    """Run data-parallel steps up to step ``steps``; return, for each
    collective run (both with ``compare``), its trainer and its per-step
    losses, gradient norms, step times and straggler monitor, and with
    ``compare`` the divergence between them. ``params`` and ``opt`` (default:
    ``LM.init(seed)`` in f32 and a fresh AdamW state) start every replica,
    and the run starts at step ``opt.step``: a state after k updates takes
    batch k next (each run's ``start_step``). With ``ckpt_dir``, the state
    after k updates is saved under label k whenever ``ckpt_every`` divides k
    (the run's ``saves``: label, seconds until ``save()`` returned, seconds
    the write took after), and ``resume`` first restores the newest label
    there, if there is one (``restored``: label, AdamW step, seconds)."""
    dp = max(dp, 1)
    if batch % dp:
        raise ValueError(f"--batch {batch} not divisible by --dp {dp}")
    if compare and dp <= 1:
        raise ValueError("--compare-collectives needs --dp > 1")
    if compare and ckpt_dir is not None:
        raise ValueError("--compare-collectives takes no checkpoints")
    if resume and ckpt_dir is None:
        raise ValueError("resume needs a checkpoint directory")
    dev = resolve_device(device)
    backend = STACKED
    if dist.is_initialized():
        backend = DistBackend()
        if backend.world != dp:
            raise ValueError(f"--dp {dp} but the process group has {backend.world} ranks")
    lm = LM(cfg, device=dev, remat=True)
    if params is None:
        params = lm.init(seed, param_dtype=torch.float32)
    ck = Checkpointer(ckpt_dir, keep=2) if ckpt_dir is not None else None
    restored = None
    if resume:
        if backend.rank is not None:
            dist.barrier()  # every rank restores what the first rank wrote
        if ck.latest_step() is not None:
            t0 = time.perf_counter()
            label, state = ck.restore({"params": params,
                                       "opt": adamw_init(params) if opt is None else opt})
            params, opt = state["params"], state["opt"]
            restored = {"step": label, "opt_step": opt.step,
                        "restore_s": time.perf_counter() - t0}
            log(f"resumed from checkpoint at step {label}")
    start = 0 if opt is None else opt.step
    lr = cosine_schedule(3e-4, warmup=20, total=max(steps, 100))
    runs = COLLECTIVES if compare else (collectives,)
    out = {name: {"trainer": Trainer(lm, params, dp, name, lr, backend, opt),
                  "loss": [], "grad_norm": [], "step_ms": [], "monitor": StragglerMonitor(),
                  "start_step": start, "restored": restored, "saves": []} for name in runs}
    del params, opt
    pipe = DataPipeline(seed=DATA_SEED, batch=batch, seq=seq, vocab=cfg.vocab_size,
                        start_step=start, device=dev)
    try:
        for _ in range(start, steps):
            step, global_batch = next(pipe)
            for name, run in out.items():
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                with StepTimer(run["monitor"]) as timer:
                    loss, gnorm = run["trainer"].step(global_batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                run["step_ms"].append((time.perf_counter() - t0) * 1e3)
                run["loss"].append(loss)
                run["grad_norm"].append(gnorm)
                if timer.verdict != "ok":
                    log(f"  [straggler] step {step} verdict={timer.verdict}")
            if compare:
                lp, lb = out["pccl"]["loss"][-1], out["builtin"]["loss"][-1]
                log(f"step {step} loss builtin={lb:.6f} pccl={lp:.6f} diff={abs(lb - lp):.3e}")
            else:
                run = out[collectives]
                log(f"step {step:4d}  loss={run['loss'][-1]:.4f}  "
                    f"gnorm={run['grad_norm'][-1]:.3f}  "
                    f"~{batch * seq / max(run['monitor'].median, 1e-9):,.0f} tok/s")
                if ck is not None and (step + 1) % ckpt_every == 0 and backend.rank in (None, 0):
                    trainer = run["trainer"]
                    t0 = time.perf_counter()
                    fut = ck.save(step + 1, {"params": trainer.replicas[0],
                                             "opt": trainer.opts[0]})
                    t1 = time.perf_counter()
                    rec = {"step": step + 1, "save_s": t1 - t0}
                    fut.add_done_callback(lambda _, rec=rec, t1=t1: rec.update(
                        write_s=time.perf_counter() - t1))
                    run["saves"].append(rec)
    finally:
        pipe.close()
        if ck is not None:
            ck.close()
    if compare:
        out["max_loss_diff"] = max(abs(a - b) for a, b in zip(out["pccl"]["loss"],
                                                              out["builtin"]["loss"]))
        out["max_param_diff"] = max_abs_diff(out["pccl"]["trainer"].replicas[0],
                                             out["builtin"]["trainer"].replicas[0])
        log(f"PCCL_CONFORMANCE max_loss_diff={out['max_loss_diff']:.3e} "
            f"max_param_diff={out['max_param_diff']:.3e}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="10m", choices=sorted(MODELS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks")
    ap.add_argument("--collectives", default="builtin", choices=COLLECTIVES,
                    help="gradient all-reduce implementation")
    ap.add_argument("--compare-collectives", action="store_true",
                    help="run every step through both and report the max divergence")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_lm_ckpt in the temporary directory")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    cfg = model_config(args.model)
    print(f"model: {cfg.name} reduced -> {cfg.param_count() / 1e6:.1f}M params, "
          f"dp={args.dp}")
    ckpt_dir = None
    if not args.compare_collectives:
        ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                 "repro_torch_train_lm_ckpt")
    t0 = time.perf_counter()
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, dp=args.dp,
                collectives=args.collectives, compare=args.compare_collectives,
                device=args.device, seed=args.seed, ckpt_dir=ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume)
    start = out["pccl" if args.compare_collectives else args.collectives]["start_step"]
    print(f"done: {args.steps - start} steps in {time.perf_counter() - t0:.1f}s"
          + (f"; checkpoints in {ckpt_dir}" if ckpt_dir else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
