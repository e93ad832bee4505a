"""Fault-tolerant checkpointing of training state, ported from
``repro/checkpoint/checkpointer.py``.

The reference's design, kept:

* **Atomic**: state is written to ``step_<n>.tmp/`` and os.rename'd to
  ``step_<n>/`` only after an fsync'd manifest, so a crash mid-write never
  leaves a half-checkpoint that ``restore()`` would pick up.
* **Async**: ``save()`` snapshots the state to host memory and hands the
  write to one background thread; training continues. ``wait()`` joins
  outstanding saves.
* **Re-placed on restore**: every leaf is saved whole; ``restore()`` puts it
  on the device that ``shardings`` names for it, else on its template
  leaf's, so a checkpoint taken by one set of ranks restores onto another.
  A DTensor leaf (a ``ShardingPolicy``'s params and their AdamW moments) is
  saved as its ``full_tensor()`` and restored split over its template's
  mesh and placements: a template initialized on the current mesh takes a
  checkpoint saved at any other mesh size (elastic restart).
* **Self-pruning**: keeps the newest ``keep`` checkpoints.

The on-disk layout is the reference's, so each package restores the
other's checkpoints: one ``<name>.npz`` per state tree, keys the
``/``-joined path of a leaf as jax names it (a dict key, or ``.<field>``
for a field of a dataclass such as ``AdamWState``, as jax names a
``NamedTuple``'s: ``.step``, ``.mu/embed/table``), plus ``manifest.json``
of ``{"step", "trees"}``. A Python int leaf (AdamW's step) is written as a
0-d int32, as jax holds the reference's. A bf16 leaf is written as numpy
writes jax's: raw 2-byte words (``V2``).

Under a process group of more than one rank, every rank calls ``save()``
(``full_tensor()`` is a collective) and the first rank alone writes; every
rank calls ``restore()``, which waits for this checkpointer's writes and
then at a barrier, so no rank reads before the first rank's writes are
done.

Two things differ from the reference because torch tensors are not jax
arrays:

* The snapshot copies. ``adamw_update`` updates params and moments in
  place, and on the CPU ``tensor.to("cpu")`` and ``.numpy()`` return the
  live storage, so ``save()`` copies every leaf to host memory and returns
  only when the copies are done.
* ``restore()`` casts every leaf to its template leaf's dtype: a ``V2``
  leaf is read as bf16, whichever package wrote it. A leaf whose template
  is not a tensor comes back as numpy (a Python number for a Python
  number).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

BF16_WORDS = np.dtype("V2")  # how numpy stores a bf16 leaf


def _rank() -> int | None:
    """This process's rank in an initialized group of more than one rank;
    None without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank()
    return None


def _join(key: str, part: str) -> str:
    return f"{key}/{part}" if key else part


def _items(tree, key: str = ""):
    """(key, leaf) of every leaf of a tree of dicts and dataclasses."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], _join(key, str(k)))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), _join(key, "." + f.name))
    else:
        yield key, tree


def _map(fn, tree, key: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, _join(key, str(k))) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), _join(key, "." + f.name))
            for f in dataclasses.fields(tree)})
    return fn(key, tree)


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else holds; of a DTensor, its
    whole value (``full_tensor()``, a collective every rank joins)."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_WORDS)
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.array(leaf)


def _restored(arr: np.ndarray, like, device):
    """``arr`` as read from disk, cast to ``like``'s type and placed on
    ``device`` (None: ``like``'s device); for a DTensor ``like``, split
    over its mesh as its placements say (``distribute_tensor``)."""
    if isinstance(like, torch.Tensor):
        if arr.dtype == BF16_WORDS:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if _is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t.to(like.device, like.dtype), like.device_mesh,
                                     like.placements)
        return t.to(like.device if device is None else device, like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr.astype(np.asarray(like).dtype, copy=False)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def save(self, step: int, state: dict) -> Future:
        """Async atomic save. ``state`` is a dict of trees (e.g. {"params":
        ..., "opt": ...}). Returns once every leaf is copied to host
        memory; the write goes on in the background. Under a group of
        more than one rank every rank calls it and the first alone writes:
        another rank's future is done when it returns."""
        host_state = {name: {key: _host(leaf) for key, leaf in _items(tree)}
                      for name, tree in state.items()}
        if _rank() not in (None, 0):
            fut = Future()
            fut.set_result(None)
            return fut
        fut = self._pool.submit(self._write, step, host_state)
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(fut)
        return fut

    def _write(self, step: int, host_state: dict):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "trees": {}}
        for name, flat in host_state.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
            manifest["trees"][name] = sorted(flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._prune()
        return final

    def _prune(self):
        done = sorted(d for d in os.listdir(self.directory)
                      if d.startswith("step_") and not d.endswith(".tmp"))
        for old in done[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, old))

    def wait(self):
        with self._lock:
            pending = list(self._pending)
        for f in pending:
            f.result()

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d,
                                               "manifest.json")):
                    steps.append(int(d.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, template: dict, *, step: int | None = None,
                shardings: dict | None = None) -> tuple[int, dict]:
        """Restore into the structure of ``template``. ``shardings`` (same
        outer keys) names, for a state tree, a ``torch.device`` for all of
        it or a tree of devices that mirrors it; pass the surviving ranks'
        devices to restore onto another set of ranks than the one that
        saved (elastic restart). A tree it does not name goes to its
        template's devices. A DTensor leaf of ``template`` is split over its
        mesh as its placements say. Under a group of more than one rank
        every rank calls it: each waits here for this checkpointer's writes
        and then at a barrier before it reads."""
        self.wait()
        if _rank() is not None:
            import torch.distributed as dist

            dist.barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for name, tree in template.items():
            where = (shardings or {}).get(name)
            if where is not None and not isinstance(where, (torch.device, str)):
                where = dict(_items(where))
            with np.load(os.path.join(path, f"{name}.npz")) as data:
                out[name] = _map(lambda key, leaf: _restored(
                    data[key], leaf,
                    where.get(key) if isinstance(where, dict) else where), tree)
        return manifest["step"], out

    def close(self):
        self.wait()
        self._pool.shutdown()
