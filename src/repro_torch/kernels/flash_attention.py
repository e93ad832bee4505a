"""Wrappers of the three CUDA flash-attention forward kernels, the table
that routes a call to one of them, and the wrapper of the backward kernel.

Both replace ``repro/kernels/flash_attention.py:flash_attention`` (Pallas):

- ``wgmma`` (``csrc/flash_attention_wgmma.cu``): TMA loads and tensor-core
  products (wgmma), for bf16 at ``WGMMA_HEAD_DIMS``: 64, and every multiple
  of 8 from 72 to 128 (those below 128 through the hd-128 instance, TMA
  filling the columns past head_dim with zeros);
- ``mma`` (``csrc/flash_attention.cu``): tensor-core products by mma.sync,
  f32 as three TF32 products (3xTF32, as one misses the f32 tolerance) and
  bf16 as one, for every other head_dim up to ``MAX_HEAD_DIM``;
- ``wide`` (``csrc/flash_attention_wide.cu``): tensor-core products by
  mma.sync as the ``mma`` route makes them, for every head_dim above
  ``MAX_HEAD_DIM``, f32 and bf16 (the reference's kernel takes any): two
  groups of 4 warps split a block's 512 output columns and Q K^T's
  contraction between them, Q and K stream through a cp.async ring of
  head_dim slices, wider head dims split over the grid.

``ROUTES`` picks the route from (dtype, head_dim); nothing is chosen by
catching a failure, and a launch or build error raises. The wrappers take
CUDA tensors only: they check them, allocate the output, launch on
PyTorch's current stream and raise if the launch failed. Each route counts
its own launches (``flash_attention_wgmma.launches``,
``flash_attention_mma.launches``, ``flash_attention_wide.launches``);
``flash_attention.launches`` is the total.

``flash_attention_bwd`` computes dq, dk and dv from q, k, v, the forward's
output and its cotangent, f32 or bf16 at every head_dim from 1 to
``BWD_MAX_HEAD_DIM``, whichever route ran the forward. It replaces the
reference's jnp VJP of its flash core
(``repro/models/attention.py:_flash_bwd_vjp``); the Pallas kernel has none.
``BWD_ROUTES`` picks one of two kernels from (dtype, head_dim), as
``ROUTES`` does for the forward:

- ``wgmma`` (``csrc/flash_attention_bwd_wgmma.cu``): TMA loads and wgmma
  products, for bf16 at head_dim 64 and 128;
- ``mma`` (``csrc/flash_attention_bwd.cu``): mma.sync products (f32 in
  3xTF32), for every other (dtype, head_dim).

Each route's three passes count as one launch of its wrapper
(``flash_attention_bwd_wgmma.launches``, ``flash_attention_bwd_mma.launches``);
``flash_attention_bwd.launches`` is the total.

``flops`` is the arithmetic of either direction, which ``kernels/ops``
registers as the FLOP formula of its operators.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256  # the widest padded width the mma kernel is built for
BWD_MAX_HEAD_DIM = 128  # the widest padded width the backward kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 head dims of the wgmma forward: TMA reads heads 16-byte aligned (a
# multiple of 8 bf16) and the epilogue stores 8 columns a group
WGMMA_HEAD_DIMS = (64, *range(72, 129, 8))


class _RouteTable(dict):
    """(dtype, head_dim) -> route: listed up to ``MAX_HEAD_DIM``; every
    wider head_dim of a taken dtype is "wide"."""

    def __missing__(self, key):
        dtype, hd = key
        if dtype in _DTYPES and isinstance(hd, int) and hd > MAX_HEAD_DIM:
            return "wide"
        raise KeyError(key)


BWD_ROUTES = {
    (dtype, hd): "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "mma"
    for dtype in _DTYPES for hd in range(1, BWD_MAX_HEAD_DIM + 1)
}
ROUTES = _RouteTable({
    (dtype, hd): "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "mma"
    for dtype in _DTYPES for hd in range(1, MAX_HEAD_DIM + 1)
})
_fns: dict[str, tuple] = {}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim): "wgmma", "mma" or "wide"."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {list(_DTYPES)}")
    try:
        return ROUTES[(dtype, head_dim)]
    except KeyError:
        raise ValueError(f"head_dim {head_dim} is not a positive integer") from None


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel that takes (dtype, head_dim): "wgmma" or "mma"."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {list(_DTYPES)}")
    try:
        return BWD_ROUTES[(dtype, head_dim)]
    except KeyError:
        raise ValueError(f"the backward kernel takes head_dim 1..{BWD_MAX_HEAD_DIM}, "
                         f"not {head_dim}") from None


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# q, k, v, o, dtype, B, S, T, H, KV, hd, strides, causal, window, softcap, scale, stream
_FWD_ARGS = [_p, _p, _p, _p, *[_i] * 7, _STRIDES, _i, _i, _f, _f, _p]
# q, k, v, o, dout, dq, dk, dv, lse, delta, then as the forward's from dtype on
_BWD_ARGS = [*[_p] * 10, *[_i] * 7, _STRIDES, _i, _i, _f, _f, _p]


def _kernel(name: str, symbol: str, err_symbol: str, argtypes=_FWD_ARGS):
    if name not in _fns:
        lib = build.load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_str = getattr(lib, err_symbol)
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fns[name] = (fn, err_str)
    return _fns[name]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}.dtype {t.dtype} not in {list(_DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides (batch, seq, head) of a [B, L, N, hd] bf16 view for
    a TMA tensor map, or ValueError if TMA cannot read it: the base must be
    16-byte aligned and each stride a multiple of 16 bytes. A dim of size 1
    is never stepped, so it gets the packed stride of the dims inside it."""
    nbytes = t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base; this view starts "
                         f"at {t.data_ptr() % 16} bytes past one")
    shape, strides = t.shape, t.stride()  # read once: each accessor call costs host time
    out = []
    inner = shape[-1]  # packed stride of the next dim out, in elements
    for dim in (2, 1, 0):
        stride = strides[dim] if shape[dim] > 1 else inner
        if stride * nbytes % 16:
            raise ValueError(f"TMA needs strides of 16-byte multiples; stride "
                             f"{stride} of dim {dim} is {stride * nbytes} bytes")
        out.append(stride)
        inner = stride * shape[dim]
    return out[2], out[1], out[0]


def _launch(name, symbol, err_symbol, q, k, v, strides, causal, window, softcap):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o, False
    st = (ctypes.c_longlong * 12)(*strides, *o.stride()[:3])
    fn, err_str = _kernel(name, symbol, err_symbol)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPES[q.dtype], B, S, T, H, KV, hd, st, int(causal),
                 int(window), float(softcap), 1.0 / math.sqrt(hd), stream)
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a tensor "
                           f"map (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    return o, True


def flash_attention_mma(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The mma.sync route: f32 or bf16, any head_dim from 1 to
    ``MAX_HEAD_DIM``."""
    _check(q, k, v)
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} outside 1..{MAX_HEAD_DIM}")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    o, launched = _launch("flash_attention", "repro_flash_attention_fwd",
                          "repro_cuda_error_string", q, k, v, strides, causal,
                          window, softcap)
    flash_attention_mma.launches += int(launched)
    return o


def flash_attention_wide(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The route for head_dims above ``MAX_HEAD_DIM``: f32 or bf16."""
    _check(q, k, v)
    if route(q.dtype, q.shape[-1]) != "wide":
        raise ValueError(f"the wide kernel takes head_dims above {MAX_HEAD_DIM}, "
                         f"not {q.shape[-1]}")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    o, launched = _launch("flash_attention_wide", "repro_flash_attention_wide_fwd",
                          "repro_wide_cuda_error_string", q, k, v, strides, causal,
                          window, softcap)
    flash_attention_wide.launches += int(launched)
    return o


def flash_attention_wgmma(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The tensor-core route: bf16 at head_dim 64 or a multiple of 8 from 72
    to 128, q/k/v readable by TMA (else ValueError; nothing goes to another
    route)."""
    _check(q, k, v)
    if route(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"the wgmma kernel takes bf16 at head_dim 64 or a multiple of 8 "
                         f"from 72 to 128, not {q.dtype} at {q.shape[-1]}")
    strides = (*tma_strides(q), *tma_strides(k), *tma_strides(v))
    o, launched = _launch("flash_attention_wgmma", "repro_flash_attention_wgmma_fwd",
                          "repro_wgmma_cuda_error_string", q, k, v, strides,
                          causal, window, softcap)
    flash_attention_wgmma.launches += int(launched)
    return o


_ROUTE_FNS = {"wgmma": flash_attention_wgmma, "mma": flash_attention_mma,
              "wide": flash_attention_wide}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """[B,S,H,hd] x [B,T,KV,hd]^2 -> [B,S,H,hd] on the card, through the
    kernel that ``ROUTES`` names for (dtype, head_dim); the route's wrapper
    checks the tensors."""
    fn = _ROUTE_FNS[route(q.dtype, q.shape[-1])]
    before = fn.launches
    o = fn(q, k, v, causal=causal, window=window, softcap=softcap)
    flash_attention.launches += fn.launches - before
    return o


def _check_bwd(q, k, v, o, dout) -> None:
    hd = q.shape[-1]
    if not 1 <= hd <= BWD_MAX_HEAD_DIM:
        raise ValueError(f"the backward kernel takes head_dim 1..{BWD_MAX_HEAD_DIM}, "
                         f"not {hd}")
    _check(q, k, v)
    B, _, H, _ = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for name, t in (("o", o), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must be like q ({tuple(q.shape)}, {q.dtype}, "
                             f"{q.device}); got {tuple(t.shape)}, {t.dtype}, {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous")


def _launch_bwd(name, symbol, err_symbol, q, k, v, o, dout, in_strides, rows,
                causal, window, softcap):
    """Allocate dq, dk, dv and the f32 row scratch (lse and D, ``rows`` a
    (b, h)) and launch backward kernel ``name``; ``in_strides`` are the 15
    element strides of q, k, v, o and dout. Returns (dq, dk, dv, launched)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), False
    lse = torch.empty((B, H, rows), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    st = (ctypes.c_longlong * 24)(*in_strides, *[s for t in (dq, dk, dv)
                                                 for s in t.stride()[:3]])
    fn, err_str = _kernel(name, symbol, err_symbol, _BWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, o, dout, dq, dk, dv, lse, delta)),
                 _DTYPES[q.dtype], B, S, T, H, KV, hd, st, int(causal), int(window),
                 float(softcap), 1.0 / math.sqrt(hd), stream)
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a tensor "
                           f"map (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    return dq, dk, dv, True


def flash_attention_bwd_mma(q, k, v, o, dout, *, causal=True, window=0, softcap=0.0):
    """The mma.sync backward: f32 or bf16 at head_dim 1 to
    ``BWD_MAX_HEAD_DIM`` (else ValueError)."""
    _check_bwd(q, k, v, o, dout)
    strides = [s for t in (q, k, v, o, dout) for s in t.stride()[:3]]
    *grads, launched = _launch_bwd("flash_attention_bwd", "repro_flash_attention_bwd",
                                   "repro_bwd_cuda_error_string", q, k, v, o, dout, strides,
                                   q.shape[1], causal, window, softcap)
    flash_attention_bwd_mma.launches += int(launched)
    return tuple(grads)


# the wgmma backward's row scratch: S rounded up to its work tiles' 128 rows
_BWD_WGMMA_ROWS = 128


def flash_attention_bwd_wgmma(q, k, v, o, dout, *, causal=True, window=0, softcap=0.0):
    """The TMA and wgmma backward: bf16 at head_dim 64 or 128, q, k, v, o
    and dout readable by TMA and on the card (else ValueError; nothing goes
    to another route)."""
    if bwd_route(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"the wgmma backward takes bf16 at head_dim 64 or 128, "
                         f"not {q.dtype} at {q.shape[-1]}")
    strides = [s for t in (q, k, v, o, dout) for s in tma_strides(t)]
    _check_bwd(q, k, v, o, dout)
    rows = -(-q.shape[1] // _BWD_WGMMA_ROWS) * _BWD_WGMMA_ROWS
    *grads, launched = _launch_bwd("flash_attention_bwd_wgmma",
                                   "repro_flash_attention_bwd_wgmma",
                                   "repro_bwd_wgmma_cuda_error_string", q, k, v, o, dout,
                                   strides, rows, causal, window, softcap)
    flash_attention_bwd_wgmma.launches += int(launched)
    return tuple(grads)


_BWD_ROUTE_FNS = {"wgmma": flash_attention_bwd_wgmma, "mma": flash_attention_bwd_mma}


def flash_attention_bwd(q, k, v, o, dout, *, causal=True, window=0, softcap=0.0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = o for the cotangent
    ``dout`` of o, on the card, in q's dtype, through the kernel that
    ``BWD_ROUTES`` names for (dtype, head_dim): f32 or bf16 at head_dim 1 to
    ``BWD_MAX_HEAD_DIM`` (else ValueError; nothing goes to plain torch)."""
    fn = _BWD_ROUTE_FNS[bwd_route(q.dtype, q.shape[-1])]
    before = fn.launches
    grads = fn(q, k, v, o, dout, causal=causal, window=window, softcap=softcap)
    flash_attention_bwd.launches += fn.launches - before
    return grads


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the causal / sliding-window masks leave
    visible: query s sees keys max(0, s - window + 1) .. min(T - 1, s)
    (causal), or all T without a mask."""
    s = np.arange(S, dtype=np.int64)
    hi = np.minimum(T - 1, s) if causal else np.full(S, T - 1, dtype=np.int64)
    lo = np.maximum(0, s - window + 1) if window > 0 else np.zeros(S, dtype=np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flops(q_shape, k_shape, causal: bool, window: int, *, backward: bool = False) -> int:
    """The products of attention over the visible (query, key) pairs:
    S = Q K^T and O = P V, 2 hd each a pair and head, forward; S recomputed,
    dP = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q, five of 2 hd,
    backward. The kernels walk key tiles and skip a tile only where the
    mask hides all of it, so the tiles astride the diagonal (and a window's
    edge) do masked work that this count leaves out: it is the work the
    function needs, the count that a bound divides by the peak rate. The
    exponentials and the softmax's elementwise work are not counted."""
    B, S, H, hd = q_shape
    T = k_shape[1]
    per_pair = (10 if backward else 4) * hd
    return B * H * per_pair * visible_pairs(S, T, causal, window)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd_mma.launches = 0
flash_attention_bwd_wgmma.launches = 0
flash_attention_mma.launches = 0
flash_attention_wgmma.launches = 0
flash_attention_wide.launches = 0
