"""Public entry points of the port's kernels, replacing
``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
kernel's plain PyTorch version (``ref.py``), which is what the CPU tests
run; any other device raises. There is no fallback from the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import flash_attention_ref


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,hd], k = v [B,T,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """[B,S,H,hd] x [B,T,KV,hd]^2 -> [B,S,H,hd]."""
    _check_qkv(q, k, v)
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    raise ValueError(f"no flash_attention for device {q.device}")
