"""Gradient compression for the cross-pod data-parallel axis, ported from
``repro/comms/compression.py``.

* ``ef_int8``: per-tensor symmetric int8 quantization with an error-feedback
  residual (the quantization error is carried into the next step).
* ``topk``: magnitude top-k sparsification with error feedback; ties go to
  the lower index, as ``lax.top_k`` breaks them.

``error_feedback_all_reduce`` runs on the stacked backend (every rank's
leaf ``[dp, ...]`` in one tensor, each row quantized with its own scale, as
each device quantizes inside the reference's ``shard_map``) or one rank a
process through ``DistBackend``. As in the reference, the reduction sums
the dequantized f32 values, not the int8 payload: no bytes are saved on the
wire.
"""

from __future__ import annotations

import math

import torch

from repro_torch.comms.executor import STACKED


def _on(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor on ``like``'s device: CUDA divides by a
    Python scalar as a product with its rounded reciprocal, which can miss
    the correctly rounded quotient (the CPU's and the reference's) by an
    ulp; a tensor divisor is divided."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _ef_int8(acc: torch.Tensor, per_row: bool = False):
    """(q, scale, new residual) of ``acc``: one 0-d scale, or with
    ``per_row`` one scale a row of the leading axis (shaped to broadcast)."""
    if per_row:
        amax = acc.abs().reshape(acc.shape[0], -1).amax(1)
        amax = amax.reshape(-1, *[1] * (acc.ndim - 1))
    else:
        amax = acc.abs().max()
    scale = amax.clamp_min(1e-30) / _on(amax, 127.0)
    q = torch.clamp(torch.round(acc / scale), -127, 127).to(torch.int8)
    return q, scale, acc - q.to(acc.dtype) * scale


def ef_int8_compress(g: torch.Tensor, residual: torch.Tensor):
    """Returns (int8 payload, 0-d scale, new_residual). residual has g's shape."""
    return _ef_int8(g + residual)


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """``q * scale`` in the promoted type of ``dtype`` and the scale's, as
    jnp promotes it (a bf16 payload times an f32 scale is f32)."""
    return q.to(torch.promote_types(dtype, scale.dtype)) * scale


def topk_compress(g: torch.Tensor, residual: torch.Tensor, k: int):
    """Keep the k largest-|.| entries (flattened); rest go to the residual.
    Returns (values[k], indices[k], new_residual). A stable descending sort
    puts equal magnitudes in index order, so ties keep the lower index."""
    acc = (g + residual).reshape(-1)
    idx = torch.sort(acc.abs(), descending=True, stable=True).indices[:k]
    vals = acc[idx]
    kept = torch.zeros_like(acc).index_put_((idx,), vals)
    return vals, idx, (acc - kept).reshape(g.shape)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape, dtype=torch.float32):
    flat = torch.zeros(math.prod(shape), dtype=dtype, device=vals.device)
    return flat.index_put_((idx,), vals.to(dtype)).reshape(shape)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def error_feedback_all_reduce(grads, residuals, *, backend=STACKED, method: str = "int8"):
    """Compressed mean over the data-parallel ranks: quantize each rank's
    leaf with its own scale, mean the dequantized payloads, return
    (reduced_grads, new_residuals) as dict trees like ``grads``.

    Stacked backend: each leaf is ``[dp, ...]``, one row a rank; each row
    of a reduced leaf is the same mean (a broadcast view of one ``[...]``
    tensor). ``DistBackend``: each leaf is this rank's, reduced by
    ``dist.all_reduce`` over the backend's group."""
    if method != "int8":
        raise NotImplementedError(method)

    def one(g, r):
        acc = g + r
        if backend.rank is None:  # stacked: one scale a row
            q, scale, new_r = _ef_int8(acc, per_row=True)
            deq = q.to(g.dtype) * scale
            mean = deq.sum(0)
            return (mean / _on(mean, acc.shape[0])).expand(g.shape), new_r
        import torch.distributed as dist

        q, scale, new_r = _ef_int8(acc)
        deq = q.to(g.dtype) * scale
        dist.all_reduce(deq, group=backend.group)
        return deq / _on(deq, backend.world), new_r

    pairs = _tree_map(one, grads, residuals)
    return _tree_map(lambda p: p[0], pairs), _tree_map(lambda p: p[1], pairs)
