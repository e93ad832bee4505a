"""Wrapper of the CUDA flash-attention forward kernel (csrc/flash_attention.cu).

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (Pallas). Takes
CUDA tensors only: it checks them, allocates the output, launches the
kernel on PyTorch's current stream and raises if the launch failed. Counts
its launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("flash_attention")
        fn = lib.repro_flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, i,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """[B,S,H,hd] x [B,T,KV,hd]^2 -> [B,S,H,hd] on the card."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}.dtype {t.dtype} not in {list(_DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPES[q.dtype], B, S, T, H, KV, hd, strides,
                 int(causal), int(window), float(softcap),
                 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
