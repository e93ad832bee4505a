"""One rank of the port's tensor-parallel tests, started by ``spawn`` from
``tests/test_torch_sharding.py`` and ``tests/test_torch_sharding_families.py``.

Imports torch, numpy and the port only (no jax), so each process starts
fast. Every rank joins a gloo group through a ``file://`` rendezvous (no
TCP port), builds the policy's mesh on the CPU, places the parent's params
on it and runs each case; rank 0 saves the full tensors for the parent to
hold against the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch


def flatten(tree, prefix=""):
    """A nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def config(arch: str, over: dict):
    from repro_torch.configs import get_config

    return get_config(arch).reduced(dtype="float32", **over)


def no_drop(cfg):
    """The config at capacity factor E / k: no (token, choice) is dropped,
    so a prefill routes as stepped decode does."""
    if not cfg.is_moe:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def _loss_and_grads(lm, params, batch):
    params = _requires_grad(params)
    loss, metrics = lm.loss(params, batch)
    loss.backward()
    grads = {k: v.grad for k, v in flatten(params).items()}
    return loss, metrics, grads


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


@contextlib.contextmanager
def planted(fault: str | None):
    """A planted fault for one case: "local_mean", the Mamba2 gated norm's
    mean of squares taken over this rank's channels alone at model > 1."""
    from repro_torch.models import LM

    if fault is None:
        yield
        return
    if fault != "local_mean":
        raise ValueError(f"unknown fault {fault!r}")
    keep = LM._mean_sq
    LM._mean_sq = lambda self, bdim, width: None
    try:
        yield
    finally:
        LM._mean_sq = keep


def run_case(pol_mesh, case: dict, inputs: dict, out_dir: Path, rank: int) -> None:
    """One case on this rank: the policy LM's prefill logits, its decode
    logits at each fed token, every leaf of its cache after them, loss,
    moe_aux and every gradient, full."""
    with planted(case.get("fault")):
        _run_case(pol_mesh, case, inputs, out_dir, rank)


def _run_case(pol_mesh, case: dict, inputs: dict, out_dir: Path, rank: int) -> None:
    from repro_torch.bridge import params_from_jax
    from repro_torch.launch.sharding import ShardingPolicy
    from repro_torch.models import LM

    cfg = config(case["arch"], case["over"])
    ep = case.get("ep", 1)
    params = params_from_jax(unflatten(inputs["params"]), "cpu", torch.float32)
    tokens = torch.from_numpy(inputs["tokens"])
    fed = torch.from_numpy(inputs["fed"])
    stub = {k: torch.from_numpy(inputs[k]) for k in ("patches", "frames") if k in inputs}
    P = stub["patches"].shape[1] if "patches" in stub else 0
    B, S = tokens.shape
    res = {}
    pol = ShardingPolicy(pol_mesh, cfg)
    placed = pol.param_shardings(params)
    with torch.no_grad():
        lm = LM(cfg, device="cpu", ep_degree=ep, policy=pol)
        res["prefill"] = lm.prefill(placed, tokens, max_seq=P + S + fed.shape[1],
                                    **stub)[0].full_tensor()
        step = LM(no_drop(cfg), device="cpu", ep_degree=ep,
                  policy=ShardingPolicy(pol_mesh, no_drop(cfg)))
        _, cache = step.prefill(placed, tokens, max_seq=P + S + fed.shape[1], **stub)
        for i in range(fed.shape[1]):
            logits, cache = step.decode_step(placed, cache, fed[:, i], P + S + i)
            res[f"decode{i}"] = logits.full_tensor()
        res.update({f"cache/{k}": t.full_tensor() for k, t in flatten(cache).items()})
    if "labels" in inputs:
        batch = {"tokens": tokens, "labels": torch.from_numpy(inputs["labels"]), **stub}
        loss, metrics, grads = _loss_and_grads(lm, placed, batch)
        res["loss"] = loss.detach()
        res["moe_aux"] = metrics["moe_aux"].detach()
        res.update({f"grad/{k}": g.full_tensor() for k, g in grads.items()})
    if rank == 0:
        np.savez(out_dir / f"{case['name']}.npz",
                 **{k: v.detach().numpy() for k, v in res.items()})


def run_aligned_moe(pol_mesh, out_dir: Path, rank: int) -> None:
    """The moe layer where each data-parallel rank holds whole routing
    groups (2 x 1024 tokens, groups of 1024): the policy LM's loss and
    gradients against the same LM without a policy on this rank."""
    from repro_torch.launch.sharding import ShardingPolicy
    from repro_torch.models import LM

    cfg = config("granite-moe-1b-a400m", {})
    tp = pol_mesh.axis_sizes["model"]
    plain = LM(cfg, device="cpu", ep_degree=tp)
    params = plain.init(0, param_dtype=torch.float32)
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1024)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    pol = ShardingPolicy(pol_mesh, cfg)
    lm = LM(cfg, device="cpu", ep_degree=tp, policy=pol)
    loss, metrics, grads = _loss_and_grads(lm, pol.param_shardings(params), batch)
    want, want_metrics, want_grads = _loss_and_grads(plain, params, batch)
    err = {k: float((g.full_tensor() - want_grads[k]).norm() / want_grads[k].norm())
           for k, g in grads.items()}
    if rank == 0:
        np.savez(out_dir / "aligned_moe.npz", loss=loss.detach().numpy(),
                 want=want.detach().numpy(), aux=metrics["moe_aux"].detach().numpy(),
                 want_aux=want_metrics["moe_aux"].detach().numpy(),
                 worst=np.array(max(err.values())))


def spawn(tmp_path: Path, shape: tuple, cases: list, limit: float = 240) -> Path:
    """Run ``cases`` on data x model gloo ranks; fail, and stop them, after
    ``limit`` seconds rather than hang. Returns the directory of rank 0's
    results."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    out = tmp_path / f"out{shape[0]}x{shape[1]}"
    out.mkdir()
    ctx = mp.start_processes(
        run_rank, nprocs=world, join=False, start_method="spawn",
        args=(world, shape, str(tmp_path / f"rdv{shape[0]}x{shape[1]}"), str(tmp_path),
              str(out), cases))
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, f"the {world} gloo ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return out


def run_rank(rank: int, world: int, shape: tuple, init_file: str, in_dir: str,
             out_dir: str, cases: list) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = make_test_mesh(*shape, device_type="cpu")
        for case in cases:
            if case["name"] == "aligned_moe":
                run_aligned_moe(mesh, Path(out_dir), rank)
                continue
            with np.load(Path(in_dir) / f"{case['inputs']}.npz") as f:
                inputs = {k: f[k] for k in f.files if not k.startswith("param/")}
                inputs["params"] = {k[6:]: f[k] for k in f.files if k.startswith("param/")}
            run_case(mesh, case, inputs, Path(out_dir), rank)
    finally:
        dist.destroy_process_group()
