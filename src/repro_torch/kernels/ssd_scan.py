"""Wrapper of the CUDA SSD chunked-scan kernel (csrc/ssd_scan.cu).

Replaces ``repro/kernels/ssd_scan.py:ssd_scan`` (Pallas). Takes CUDA f32
tensors only: it checks them, allocates the output and the kernel's scratch
(each chunk's state, [B, H, nc, P, N], and its total decay, [B, H, nc]),
launches the kernel's passes on PyTorch's current stream and raises if a
launch failed. With ``state_out`` it also writes the f32 state after the
last position there. Counts its calls in ``ssd_scan.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)
STATE_SIZES = (8, 16, 32, 64, 128)
MAX_CHUNK = 128
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("ssd_scan")
        fn = lib.repro_ssd_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), p]
        fn.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             state_out: torch.Tensor | None = None) -> torch.Tensor:
    """xh [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,N] -> y [B,S,H,P] on the
    card; ``state_out`` [B,H,P,N] f32 (contiguous) receives the final state."""
    named = (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    if state_out is not None:
        named += (("state_out", state_out),)
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}.dtype {t.dtype}; the kernel takes float32")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("the SSD scan's tensors must be on one device")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"head_dim {P} not in {HEAD_DIMS}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not in {STATE_SIZES}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}")
    if A.ndim != 1 or not A.is_contiguous():
        raise ValueError("A must be a contiguous [H] tensor")
    if state_out is not None and (state_out.shape != (B, H, P, N)
                                  or not state_out.is_contiguous()):
        raise ValueError(f"state_out must be a contiguous {(B, H, P, N)} tensor")
    y = torch.empty_like(xh, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        if state_out is not None:
            state_out.zero_()
        return y
    nc = -(-S // chunk)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=xh.device)
    totals = torch.empty((B, H, nc), dtype=torch.float32, device=xh.device)
    strides = (ctypes.c_longlong * 12)(
        *xh.stride()[:3], *dt.stride()[:2], *Bm.stride()[:2],
        *Cm.stride()[:2], *y.stride()[:3])
    fn, err_str = _kernel()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = fn(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(),
                 None if state_out is None else state_out.data_ptr(),
                 states.data_ptr(), totals.data_ptr(), B, S, H, P, N, int(chunk),
                 strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
