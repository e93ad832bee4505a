"""Deterministic synthetic-token data pipeline, ported from
``repro/data/pipeline.py``.

Batches are a function of (seed, step) alone (``_batch_for_step``, a copy of
the reference's numpy code), so both stacks see the same tokens and a
pipeline restarted at ``start_step`` yields exactly the batches the original
would have. A background thread keeps ``prefetch`` batches ready, as torch
tensors on ``device``. A data-parallel rank takes its rows of the global
batch with ``shard_batch`` (the reference builds its per-device shards with
``jax.make_array_from_callback``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch


def _batch_for_step(seed: int, step: int, batch: int, seq: int,
                    vocab: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(step) * 1000003)
    tokens = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1  # masked
    return {"tokens": tokens, "labels": labels}


def stub_inputs(cfg, batch: int, seed: int) -> dict[str, np.ndarray]:
    """The frontend stubs' embeddings for ``cfg`` (a ``ModelConfig``), seeded
    N(0, 1) in f32: ``frames`` [batch, encoder_seq, d_model] for the encdec
    family (whisper's audio frames after its conv frontend), ``patches``
    [batch, num_patches, d_model] for the vlm (llava's anyres image
    patches), nothing for the others. The model casts them to its compute
    dtype, as the reference's ``.astype(dtype)`` does."""
    shape = {"encdec": ("frames", cfg.encoder_seq),
             "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if shape is None:
        return {}
    name, n = shape
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal((batch, n, cfg.d_model), dtype=np.float32)}


def synthetic_lm_batches(seed: int, batch: int, seq: int, vocab: int):
    """Infinite deterministic iterator of {tokens, labels} numpy batches."""
    step = 0
    while True:
        yield _batch_for_step(seed, step, batch, seq, vocab)
        step += 1


def shard_batch(batch: dict, rank: int, num_ranks: int) -> dict:
    """Rank ``rank``'s rows of a global batch: the ``rank``-th of
    ``num_ranks`` equal slices of the leading axis."""
    rows = next(iter(batch.values())).shape[0]
    if rows % num_ranks:
        raise ValueError(f"a batch of {rows} rows does not split over {num_ranks} ranks")
    n = rows // num_ranks
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


@dataclass
class DataPipeline:
    """Deterministic, restartable, prefetching pipeline of
    ``(step, {"tokens", "labels"})``, int64 tensors on ``device``."""

    seed: int
    batch: int
    seq: int
    vocab: int
    start_step: int = 0
    prefetch: int = 2
    device: str | torch.device = "cpu"

    def __post_init__(self):
        self._queue: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._step = self.start_step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _produce_one(self, step: int) -> dict[str, torch.Tensor]:
        host = _batch_for_step(self.seed, step, self.batch, self.seq, self.vocab)
        return {k: torch.from_numpy(v).to(self.device, torch.int64)
                for k, v in host.items()}

    def _producer(self):
        step = self.start_step
        while not self._stop.is_set():
            item = self._produce_one(step)
            while not self._stop.is_set():
                try:
                    self._queue.put((step, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        step, item = self._queue.get()
        self._step = step + 1
        return step, item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
