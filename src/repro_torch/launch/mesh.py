"""Device meshes, ported from ``repro/launch/mesh.py`` and the mesh helper of
``repro/jaxcompat.py``.

A :class:`Mesh` carries its axis names and sizes and nothing else, so a
production mesh's sharding specs can be computed anywhere (256 ranks are
not needed to read them). Its torch ``DeviceMesh`` is built on first use of
``Mesh.device_mesh``, once a process group of the mesh's size exists:
rank ``r`` sits at the row-major coordinate of ``r`` in ``shape``, as the
reference lays devices out. The device type is ``cuda`` unless a caller
asks for ``cpu`` (the tests, on gloo ranks); nothing falls back from one to
the other. ``launch_group`` gives the launchers their process group and
their mesh (1, n).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and sizes, in the reference's order (major to minor)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device_type: str = "cuda"

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} and sizes {self.shape} differ "
                             f"in length")
        if self.device_type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device type {self.device_type!r}; use 'cuda' or 'cpu'")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @functools.cached_property
    def device_mesh(self):
        """The torch ``DeviceMesh`` over the current process group, built on
        first use. Raises without a card for ``cuda``, and unless the
        group's world size is the mesh's size."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if self.device_type == "cuda":
            resolve_device("cuda")
        if not dist.is_initialized():
            raise RuntimeError(f"a {self.shape} mesh needs a process group of {self.size} "
                               f"ranks; call torch.distributed.init_process_group first")
        if dist.get_world_size() != self.size:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks; the "
                             f"mesh {dict(self.axis_sizes)} needs {self.size}")
        return DeviceMesh(self.device_type, torch.arange(self.size).reshape(self.shape),
                          mesh_dim_names=self.axis_names)


def make_mesh(axis_shapes, axis_names, *, device_type: str = "cuda") -> Mesh:
    """The counterpart of ``jaxcompat.make_mesh``: a mesh of these sizes and
    names. jax's axis types have no torch counterpart: every axis here is
    explicit, its collectives called by the code that needs them."""
    return Mesh(tuple(axis_names), tuple(int(n) for n in axis_shapes), device_type)


@contextlib.contextmanager
def launch_group(device=None):
    """The launchers' process group and mesh: yields ``(mesh, device)``,
    the mesh ``(1, n)`` on ("data", "model") over the group's n ranks (the
    reference's ``make_mesh((1, jax.device_count()), ...)``) and this rank's
    device. ``device``: 'cuda' (the default; raises without a card) or
    'cpu'.

    A group already initialized is used as it is. Else, under torchrun's
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), one starts from
    that environment: NCCL on the card ``LOCAL_RANK`` names, gloo on the
    CPU. Else a one-rank group starts through a ``file://`` rendezvous in a
    temporary directory (no port). Only a group started here is ended on
    exit."""
    import torch.distributed as dist

    dev = resolve_device(device)
    started, where = False, None
    try:
        if not dist.is_initialized():
            env = os.environ
            torchrun = all(k in env for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"))
            if dev.type == "cuda":
                if torchrun:
                    torch.cuda.set_device(int(env["LOCAL_RANK"]))
                dev = resolve_device("cuda")
            kw = ({"backend": "nccl", "device_id": dev} if dev.type == "cuda"
                  else {"backend": "gloo"})
            if torchrun:
                dist.init_process_group(init_method="env://", rank=int(env["RANK"]),
                                        world_size=int(env["WORLD_SIZE"]), **kw)
            else:
                where = tempfile.mkdtemp()
                dist.init_process_group(init_method=f"file://{where}/rendezvous", rank=0,
                                        world_size=1, **kw)
            started = True
        yield make_mesh((1, dist.get_world_size()), ("data", "model"), device_type=dev.type), dev
    finally:
        if started:
            dist.destroy_process_group()
        if where is not None:
            shutil.rmtree(where, ignore_errors=True)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips (one TPU-v5e-like pod,
    2D torus). Multi-pod: (pod=2, data=16, model=16) = 512 chips; the pod
    axis is pure data parallelism across the DCI."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_test_mesh(data: int = 2, model: int = 4, *, pods: int = 0,
                   device_type: str = "cuda") -> Mesh:
    """A small mesh: one rank a device of a process group of its size."""
    if pods:
        return make_mesh((pods, data, model), ("pod", "data", "model"),
                         device_type=device_type)
    return make_mesh((data, model), ("data", "model"), device_type=device_type)


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.axis_sizes.get(name, 1)
