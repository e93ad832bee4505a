"""Multi-pod dry run of the port: the counterpart of ``repro/launch/dryrun.py``.

For every (architecture x input shape x mesh) cell on the production
meshes it answers the reference's question without the chips: does the
step build and run, and what does it cost each device? The reference
lowers and compiles each cell through XLA on 512 placeholder host devices
and reads the compiled program. The port runs each cell's step once, on
fake tensors, as rank 0 of a fake process group of the mesh's size:

- one fake process group a process (``torch.testing._internal.distributed.
  fake_pg``: every collective returns at once and moves nothing) of 256
  (pod, 16 x 16) or 512 (multipod, 2 x 16 x 16) ranks, and the production
  mesh on it (``launch/mesh.py:make_production_mesh``);
- under ``FakeTensorMode``, the bundle's stand-ins (``launch/steps.py:
  build_bundle``) placed on the mesh by their specs as DTensors whose local
  tensors are rank 0's shards: params, AdamW state, batch and cache;
- the step run once through ``launch/op_cost.py:analyze``, which counts
  every op, kernel operator and collective at the shapes of the local
  tensors, and follows the storages the step creates.

So the trace is the card's own path: DTensor's collectives and, on
``--device cuda``, the hand-written kernels' operators through their fake
implementations (``kernels/ops``). Fake CUDA DTensors need a torch built
with CUDA; ``--device cuda`` raises without one and does not go on on the
CPU. Nothing is allocated on the card.

The decode step runs at position ``seq_len - 1``, a concrete one: the
reference's abstract trace covers every position, and the port's decode
step reads its position as a Python int. The AdamW counter is a Python int
in the port's state, so neither it nor the position is an argument on the
device.

Each cell records the reference's fields where the port has them:

- ``memory``: ``argument_bytes`` (the local bytes of the placed
  arguments), ``output_bytes`` (of the step's outputs), ``alias_bytes``
  (outputs that are donated arguments, per ``donate_argnums``: the
  AdamW-updated params and moments, the decode cache), ``temp_bytes``
  (the peak of the storages that the step creates alive at once, outputs
  included: what the step allocates above its arguments);
- ``flops``, ``bytes_accessed``, ``transcendentals``, ``collective_bytes``
  and ``collective_counts`` by the reference's five kinds, per device;
- ``params``, ``active_params``, ``padded_heads``, ``orig_heads``;
- ``flops_by_op``, the FLOPs by op (aten, kernel operator), largest first,
  which the reference's HLO count cannot split out;
- ``trace_s`` and ``total_s`` in place of the XLA-only ``lower_s``,
  ``compile_s``, ``code_bytes``, ``xla_flat_*`` and ``flat_collectives``;
- on ``--device cuda``, ``device_allocated_bytes``: the card's allocated
  bytes before and after the cell, which stay the same.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells, card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch llama3.2-1b --shape decode_32k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/dryrun_torch.json

Results are cached incrementally: re-runs skip completed cells.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import REGISTRY, SHAPES, ShapeSpec, get_config, shape_applicable
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.op_cost import COLLECTIVE_KINDS, analyze, local_tensors
from repro_torch.launch.steps import ACCUM_STEPS, StepBundle, build_bundle
from repro_torch.optim import AdamWState

DEFAULT_OUT = "results/dryrun_torch.json"
MESH_SIZES = {"pod": 256, "multipod": 512}


def fake_group(world_size: int) -> None:
    """The process's default group: rank 0 of a fake group of
    ``world_size`` ranks (collectives move nothing). A fake group of
    another size is ended first; any other group raises, since the default
    group is the process's own."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} group is already running; the dry "
                               f"run needs a fake group of {world_size} ranks in a process "
                               f"of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def local_shape(shape, placements, mesh_shape) -> list[int]:
    """Rank 0's shard of ``shape`` under ``placements``: the first chunk of
    each split (``torch.chunk``'s, rounded up), mesh axes major to minor."""
    out = list(shape)
    for axis, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // mesh_shape[axis])
    return out


def _place_tree(policy, stand_in, spec, device):
    from torch.distributed.tensor import DTensor

    if isinstance(stand_in, dict):
        return {k: _place_tree(policy, stand_in[k], spec[k], device) for k in stand_in}
    placements = policy.placements(spec)
    local = torch.empty(local_shape(stand_in.shape, placements, policy.mesh.shape),
                        dtype=stand_in.dtype, device=device)
    return DTensor.from_local(local, policy.device_mesh, placements, run_check=False,
                              shape=stand_in.shape, stride=stand_in.stride())


def place_args(bundle: StepBundle, device) -> tuple:
    """The bundle's arguments on its mesh, each a DTensor of rank 0's
    shard (under ``FakeTensorMode``, fake ones); the AdamW counter and the
    decode position as Python ints (0 and ``seq_len - 1``)."""
    policy = bundle.lm.policy
    args = []
    for stand_in, spec in zip(bundle.args, bundle.in_shardings):
        if isinstance(stand_in, AdamWState):
            args.append(AdamWState(0, _place_tree(policy, stand_in.mu, spec.mu, device),
                                   _place_tree(policy, stand_in.nu, spec.nu, device)))
        else:
            args.append(_place_tree(policy, stand_in, spec, device))
    if bundle.shape.kind == "decode":
        args[-1] = bundle.shape.seq_len - 1
    return tuple(args)


def storage_bytes(tensors) -> int:
    """The bytes of the storages under ``tensors``, each storage once."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _memory(args, out, donate_argnums, temp_bytes: int) -> dict:
    arg_tensors = local_tensors(args)
    out_tensors = local_tensors(out)
    donated = {id(t.untyped_storage()) for i in donate_argnums
               for t in local_tensors(args[i])}
    return {
        "argument_bytes": storage_bytes(arg_tensors),
        "output_bytes": storage_bytes(out_tensors),
        "temp_bytes": temp_bytes,
        "alias_bytes": storage_bytes([t for t in out_tensors
                                       if id(t.untyped_storage()) in donated]),
    }


def _device_allocated(device_type: str):
    """The card's allocated bytes on a CUDA mesh (the dry run allocates
    none); None on the CPU."""
    return torch.cuda.memory_allocated() if device_type == "cuda" else None


def run_cell(arch: str, shape: str | ShapeSpec, mesh_name: str, mesh: Mesh, *,
             accum_steps: int | None = None) -> dict:
    """One cell's record. ``shape`` is a ``SHAPES`` name or a ``ShapeSpec``;
    ``mesh`` is the production mesh named ``mesh_name`` (or any mesh of
    the fake group's size); ``accum_steps`` as ``build_bundle`` takes it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": spec.name, "mesh": mesh_name}
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, spec.name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    before = _device_allocated(mesh.device_type)
    try:
        bundle = build_bundle(arch, spec, mesh, accum_steps=accum_steps)
        device = torch.device(mesh.device_type)
        mesh.device_mesh  # built on real tensors, before the fake mode
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = place_args(bundle, device)
            t1 = time.time()
            out, cost = analyze(bundle.fn, *args)
            t_trace = time.time() - t1
            memory = _memory(args, out, bundle.donate_argnums, cost.peak_bytes)
        del out, args
        rec.update(
            status="ok",
            trace_s=round(t_trace, 2),
            memory=memory,
            flops=cost.flops,
            bytes_accessed=cost.bytes,
            transcendentals=cost.transcendentals,
            flops_by_op=dict(sorted(cost.flops_by_op.items(), key=lambda kv: -kv[1])),
            collective_bytes={k: cost.collective_bytes.get(k, 0) for k in COLLECTIVE_KINDS}
            | {k: v for k, v in cost.collective_bytes.items() if k not in COLLECTIVE_KINDS},
            collective_counts={k: cost.collective_counts.get(k, 0) for k in COLLECTIVE_KINDS}
            | {k: v for k, v in cost.collective_counts.items() if k not in COLLECTIVE_KINDS},
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            padded_heads=bundle.cfg.num_heads,
            orig_heads=cfg.num_heads,
        )
        if spec.kind == "train":
            rec["accum_steps"] = (accum_steps if accum_steps is not None
                                  else ACCUM_STEPS.get(arch, 1))
    except Exception as e:  # noqa: BLE001 — record, don't abort the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    after = _device_allocated(mesh.device_type)
    if before is not None:
        rec["device_allocated_bytes"] = [before, after]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def in_child(arch: str, shape: str, mesh: str, device: str | None = None) -> int:
    """``python -m repro_torch.launch.dryrun`` of one cell in a child
    process, as the launchers' ``--dry-run`` hands off (the reference's
    command; ``--device`` is passed on when given): the fake process group
    needs a process of its own. Returns the child's exit code."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh]
    if device is not None:
        cmd += ["--device", device]
    return subprocess.call(cmd, env=dict(os.environ))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default=None, choices=[None, "pod", "multipod"],
                    help="default: both")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type: fake 'cuda' tensors through the "
                         "kernels' operators (needs a torch built with CUDA), or 'cpu'")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("--device cuda needs a torch built with CUDA; this one is not "
                           "(use --device cpu for the CPU path)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: dict[str, dict] = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    mesh_names = [args.mesh] if args.mesh else ["pod", "multipod"]
    archs = [args.arch] if args.arch else sorted(REGISTRY)
    shapes = [args.shape] if args.shape else list(SHAPES)

    failures = 0
    for mesh_name in mesh_names:
        keys = [f"{arch}|{shape}|{mesh_name}" for arch in archs for shape in shapes]
        todo = [k for k in keys if args.force or results.get(k, {}).get("status")
                not in ("ok", "skipped")]
        if not todo:
            continue
        fake_group(MESH_SIZES[mesh_name])
        mesh = make_production_mesh(multi_pod=mesh_name == "multipod",
                                    device_type=args.device)
        for key in todo:
            arch, shape_name, _ = key.split("|")
            print(f"[dryrun] {key} ...", flush=True)
            rec = run_cell(arch, shape_name, mesh_name, mesh)
            results[key] = rec
            status = rec["status"]
            extra = ""
            if status == "ok":
                extra = (f"trace={rec['trace_s']}s "
                         f"flops/dev={rec['flops']:.3g} "
                         f"temp={rec['memory']['temp_bytes']/2**30:.2f}GiB")
            elif status == "error":
                extra = rec["error"][:160]
                failures += 1
            print(f"[dryrun] {key}: {status} {extra}", flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print(f"[dryrun] done; {failures} failures; results in {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
