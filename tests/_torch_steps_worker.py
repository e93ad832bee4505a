"""One rank of ``tests/test_torch_steps.py``'s tensor-parallel case, started
by ``spawn``: the train kind of ``launch.steps.build_bundle`` on a data x
model gloo mesh; and ``hold_update``, the comparison of two AdamW steps
that this file and ``tests/test_torch_cuda.py`` share.

Imports torch, numpy and the port only (no jax). Every rank joins a gloo
group through a ``file://`` rendezvous (no TCP port), builds the bundle on
the reduced f32 config, places the parent's params on the mesh, runs one
step on the parent's batch, and rank 0 saves the metrics, the updated
params and the AdamW moments, full.
"""

from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
from _torch_tp_worker import flatten, unflatten


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def hold_update(got: dict, want: dict, old: dict, tol: float) -> None:
    """Each param leaf's step (new - old) of one AdamW step against
    ``want``'s, within rel-L2 ``tol`` over the elements whose gradient the
    step resolves. The first step moves an element by about lr x sign(g)
    for any |g| above eps, so where |g| lies below the bf16 resolution of
    the leaf's gradient (2^-8 x its largest |g|) in both runs, its sign is
    rounding noise and one run may step where the other does not
    (one element of reduced llama's 65536 in ``mlp/up``, gradient -4.8e-7
    against 0.0, moves that leaf's rel-L2 to 3.7e-3). There the gradients,
    read from the first moments (mu = 0.1 g), must agree within that
    resolution."""
    assert sorted(got) == sorted(want)
    for k in (k for k in got if k.startswith("param/")):
        g, w = got["mu" + k[5:]], want["mu" + k[5:]]
        floor = 2**-8 * np.abs(w).max()
        noise = (np.abs(g) < floor) & (np.abs(w) < floor)
        assert np.abs(g - w)[noise].max(initial=0.0) <= floor, k
        assert rel_l2((got[k] - old[k])[~noise], (want[k] - old[k])[~noise]) <= tol, k


def reduced_config(arch: str):
    from repro_torch.configs import get_config

    return get_config(arch).reduced(dtype="float32")


def train_once(mesh, arch: str, accum: int, params: dict, batch: dict):
    """One train step of the bundle on ``mesh`` from ``params`` (a plain
    tree): (metrics as floats, {"param/...", "mu/...", "nu/...": the updated
    params and AdamW moments as full plain tensors})."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init

    B, S = batch["tokens"].shape
    keep = steps.get_config
    steps.get_config = reduced_config
    try:
        bundle = steps.build_bundle(arch, ShapeSpec("t", S, B, "train"), mesh,
                                    accum_steps=accum)
    finally:
        steps.get_config = keep
    placed = bundle.lm.policy.param_shardings(params)
    new, opt, metrics = bundle.fn(placed, adamw_init(placed), batch)
    trees = {"param": new, "mu": opt.mu, "nu": opt.nu}
    return ({k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
             for k, v in metrics.items()},
            {f"{name}/{k}": v.full_tensor() for name, tree in trees.items()
             for k, v in flatten(tree).items()})


def spawn(tmp_path: Path, shape: tuple, arch: str, accum: int, limit: float = 240) -> Path:
    """Run the step on data x model gloo ranks from ``tmp_path / "in.npz"``;
    fail, and stop them, after ``limit`` seconds rather than hang. Returns
    rank 0's result file."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    out = tmp_path / f"out{shape[0]}x{shape[1]}.npz"
    ctx = mp.start_processes(
        run_rank, nprocs=world, join=False, start_method="spawn",
        args=(world, shape, str(tmp_path / f"rdv{shape[0]}x{shape[1]}"),
              str(tmp_path / "in.npz"), str(out), arch, accum))
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, f"the {world} gloo ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return out


def run_rank(rank: int, world: int, shape: tuple, init_file: str, in_file: str,
             out_file: str, arch: str, accum: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        with np.load(in_file) as f:
            params = unflatten({k[6:]: torch.from_numpy(f[k]) for k in f.files
                                if k.startswith("param/")})
            batch = {k: torch.from_numpy(f[k]) for k in ("tokens", "labels")}
        metrics, state = train_once(make_test_mesh(*shape, device_type="cpu"), arch, accum,
                                    params, batch)
        if rank == 0:
            np.savez(out_file, **{f"metric/{k}": np.array(v) for k, v in metrics.items()},
                     **{k: v.detach().numpy() for k, v in state.items()})
    finally:
        dist.destroy_process_group()
