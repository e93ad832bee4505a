"""Public entry points of the port's kernels, replacing
``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
kernel's plain PyTorch version (``ref.py``), which is what the CPU tests
run; any other device raises. There is no fallback from the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)


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


def flash_attention_bwd(q, k, v, o, dout, *, causal=True, window=0, softcap=0.0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = o for the cotangent
    ``dout`` of o, in the inputs' dtypes."""
    _check_qkv(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} must be "
                         f"shaped as q {tuple(q.shape)}")
    if q.device.type == "cuda":
        return _fa.flash_attention_bwd(q, k, v, o, dout, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, dout, causal=causal, window=window,
                                       softcap=softcap)
    raise ValueError(f"no flash_attention_bwd for device {q.device}")


def _check_ssd(xh, dt, A, Bm, Cm) -> None:
    if xh.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 3 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"want xh [B,S,H,P], dt [B,S,H], A [H], Bm = Cm "
                         f"[B,S,N]; got {tuple(xh.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, _ = xh.shape
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape[:2] != (B, S):
        raise ValueError(f"xh {tuple(xh.shape)} does not fit dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}")


def ssd_scan(xh, dt, A, Bm, Cm, *, chunk=128, return_state=False):
    """Chunked SSD: [B,S,H,P] inputs -> [B,S,H,P] outputs, and with
    ``return_state`` also the f32 state after the last position
    [B,H,P,N]."""
    _check_ssd(xh, dt, A, Bm, Cm)
    if xh.device.type == "cuda":
        state = None
        if return_state:
            B, _, H, P = xh.shape
            state = torch.empty((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                                device=xh.device)
        y = _ssd.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, state_out=state)
        return (y, state) if return_state else y
    if xh.device.type == "cpu":
        return ssd_scan_ref(xh, dt, A, Bm, Cm, chunk=chunk,
                            return_state=return_state)
    raise ValueError(f"no ssd_scan for device {xh.device}")


def ssd_scan_bwd(xh, dt, A, Bm, Cm, dy, *, chunk=128):
    """(dxh, ddt, dA, dBm, dCm) of ``ssd_scan(xh, dt, A, Bm, Cm)`` = y for
    the cotangent ``dy`` [B,S,H,P] of y."""
    _check_ssd(xh, dt, A, Bm, Cm)
    if dy.shape != xh.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be shaped as xh {tuple(xh.shape)}")
    if xh.device.type == "cuda":
        return _ssd.ssd_scan_bwd(xh, dt, A, Bm, Cm, dy, chunk=chunk)
    if xh.device.type == "cpu":
        return ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy, chunk=chunk)
    raise ValueError(f"no ssd_scan_bwd for device {xh.device}")
