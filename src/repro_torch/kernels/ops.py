"""Public entry points of the port's kernels, replacing
``repro/kernels/ops.py``.

Each entry point is one operator of the ``repro_torch`` namespace
(``torch.ops.repro_torch.flash_attention``, ``flash_attention_bwd``,
``ssd_scan``, ``ssd_scan_bwd``), registered through ``torch.library``
(``define`` / ``impl``: a lower host cost a call than ``custom_op``'s
wrapper). Its ``CUDA`` implementation is the hand-written kernel's wrapper,
its ``CPU`` implementation the kernel's plain PyTorch version (``ref.py``),
which is what the CPU tests run; the functions here raise for any other
device. There is no fallback from the kernel: the dispatcher picks the
implementation by the tensors' device, never by catching a failure.

Each operator also has a fake implementation, which gives its outputs'
shapes, dtypes and strides as the kernels give them (every output
contiguous) without computing them, so that a trace under
``FakeTensorMode`` (``launch/dryrun.py``) passes through the kernels of
the card's path; and a FLOP formula (``torch.utils.flop_counter``), the
kernel modules' ``flops``, which ``launch/op_cost.py`` reads. The kernels'
scratch (the flash backward's row statistics, the SSD scan's chunk states)
is allocated inside the wrappers and has no fake counterpart.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window, "
            "float softcap) -> Tensor")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor dout, "
            "bool causal, int window, float softcap) -> (Tensor, Tensor, Tensor)")
_LIB.define("ssd_scan(Tensor xh, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, int chunk, "
            "bool return_state) -> (Tensor, Tensor)")
_LIB.define("ssd_scan_bwd(Tensor xh, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, "
            "Tensor dy, int chunk) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
OPS = torch.ops.repro_torch


def _packed(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous()


def _no_state(xh: torch.Tensor) -> torch.Tensor:
    """The state output of a scan called without ``return_state``."""
    return xh.new_empty((0,), dtype=torch.float32)


# -- CUDA: the kernels' wrappers ------------------------------------------------

def _flash_cuda(q, k, v, causal, window, softcap):
    return _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)


def _flash_bwd_cuda(q, k, v, o, dout, causal, window, softcap):
    return _fa.flash_attention_bwd(q, k, v, o, dout, causal=causal, window=window,
                                   softcap=softcap)


def _ssd_cuda(xh, dt, A, Bm, Cm, chunk, return_state):
    state = _no_state(xh)
    if return_state:
        B, _, H, P = xh.shape
        state = torch.empty((B, H, P, Bm.shape[-1]), dtype=torch.float32, device=xh.device)
    y = _ssd.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk,
                      state_out=state if return_state else None)
    return y, state


def _ssd_bwd_cuda(xh, dt, A, Bm, Cm, dy, chunk):
    return _ssd.ssd_scan_bwd(xh, dt, A, Bm, Cm, dy, chunk=chunk)


# -- CPU: the plain versions, their outputs laid out as the kernels' -----------

def _flash_cpu(q, k, v, causal, window, softcap):
    return _packed(flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap))


def _flash_bwd_cpu(q, k, v, o, dout, causal, window, softcap):
    return tuple(_packed(g) for g in flash_attention_bwd_ref(
        q, k, v, o, dout, causal=causal, window=window, softcap=softcap))


def _ssd_cpu(xh, dt, A, Bm, Cm, chunk, return_state):
    if return_state:
        y, state = ssd_scan_ref(xh, dt, A, Bm, Cm, chunk=chunk, return_state=True)
        return _packed(y), _packed(state)
    return _packed(ssd_scan_ref(xh, dt, A, Bm, Cm, chunk=chunk)), _no_state(xh)


def _ssd_bwd_cpu(xh, dt, A, Bm, Cm, dy, chunk):
    def run():
        return tuple(_packed(g) for g in ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy, chunk=chunk))

    if torch._C._dispatch_tls_is_dispatch_key_excluded(
            torch._C.DispatchKey.AutogradFunctionality):
        # Called from a dispatch mode's handler (a cost count, a schema
        # check), which runs with autograd off in its thread; the plain
        # version differentiates the chunked scan, so it runs in a thread
        # of its own.
        with ThreadPoolExecutor(1) as pool:
            return pool.submit(run).result()
    return run()


# -- fake: shapes, dtypes and strides only -------------------------------------

def _empty(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, memory_format=torch.contiguous_format)


def _flash_fake(q, k, v, causal, window, softcap):
    return _empty(q)


def _flash_bwd_fake(q, k, v, o, dout, causal, window, softcap):
    return _empty(q), _empty(k), _empty(v)


def _ssd_fake(xh, dt, A, Bm, Cm, chunk, return_state):
    if not return_state:
        return _empty(xh), _no_state(xh)
    B, _, H, P = xh.shape
    return _empty(xh), xh.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32)


def _ssd_bwd_fake(xh, dt, A, Bm, Cm, dy, chunk):
    return tuple(_empty(t) for t in (xh, dt, A, Bm, Cm))


for _name, _cuda, _cpu, _fake in (
        ("flash_attention", _flash_cuda, _flash_cpu, _flash_fake),
        ("flash_attention_bwd", _flash_bwd_cuda, _flash_bwd_cpu, _flash_bwd_fake),
        ("ssd_scan", _ssd_cuda, _ssd_cpu, _ssd_fake),
        ("ssd_scan_bwd", _ssd_bwd_cuda, _ssd_bwd_cpu, _ssd_bwd_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)


# -- FLOP formulas (shapes in, FLOPs out) --------------------------------------

@register_flop_formula(OPS.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, softcap, *, out_shape=None):
    return _fa.flops(q_shape, k_shape, causal, window)


@register_flop_formula(OPS.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, dout_shape, causal, window,
                     softcap, *, out_shape=None):
    return _fa.flops(q_shape, k_shape, causal, window, backward=True)


@register_flop_formula(OPS.ssd_scan)
def _ssd_flops(xh_shape, dt_shape, A_shape, Bm_shape, Cm_shape, chunk, return_state, *,
               out_shape=None):
    return _ssd.flops(xh_shape, Bm_shape[-1], chunk)


@register_flop_formula(OPS.ssd_scan_bwd)
def _ssd_bwd_flops(xh_shape, dt_shape, A_shape, Bm_shape, Cm_shape, dy_shape, chunk, *,
                   out_shape=None):
    return _ssd.flops(xh_shape, Bm_shape[-1], chunk, backward=True)


# -- the entry points -------------------------------------------------------------

def _on_card_or_cpu(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {name} for device {t.device}")


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
    _on_card_or_cpu("flash_attention", q)
    return OPS.flash_attention.default(q, k, v, bool(causal), int(window), float(softcap))


def flash_attention_bwd(q, k, v, o, dout, *, causal=True, window=0, softcap=0.0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = o for the cotangent
    ``dout`` of o, in the inputs' dtypes."""
    _check_qkv(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} must be "
                         f"shaped as q {tuple(q.shape)}")
    _on_card_or_cpu("flash_attention_bwd", q)
    return OPS.flash_attention_bwd.default(q, k, v, o, dout, bool(causal), int(window),
                                           float(softcap))


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
    _on_card_or_cpu("ssd_scan", xh)
    y, state = OPS.ssd_scan.default(xh, dt, A, Bm, Cm, int(chunk), bool(return_state))
    return (y, state) if return_state else y


def ssd_scan_bwd(xh, dt, A, Bm, Cm, dy, *, chunk=128):
    """(dxh, ddt, dA, dBm, dCm) of ``ssd_scan(xh, dt, A, Bm, Cm)`` = y for
    the cotangent ``dy`` [B,S,H,P] of y."""
    _check_ssd(xh, dt, A, Bm, Cm)
    if dy.shape != xh.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be shaped as xh {tuple(xh.shape)}")
    _on_card_or_cpu("ssd_scan_bwd", xh)
    return OPS.ssd_scan_bwd.default(xh, dt, A, Bm, Cm, dy, int(chunk))
