"""Wrappers of the three CUDA flash-attention forward kernels, and the table
that routes a call to one of them.

Both replace ``repro/kernels/flash_attention.py:flash_attention`` (Pallas):

- ``wgmma`` (``csrc/flash_attention_wgmma.cu``): TMA loads and tensor-core
  products (wgmma), for bf16 at head_dim 64 and 128;
- ``mma`` (``csrc/flash_attention.cu``): tensor-core products by mma.sync,
  f32 as three TF32 products (3xTF32, as one misses the f32 tolerance) and
  bf16 as one, for every other head_dim up to ``MAX_HEAD_DIM``;
- ``wide`` (``csrc/flash_attention_wide.cu``): f32 FMAs, scores summed over
  head_dim slices staged in shared memory, for every head_dim above
  ``MAX_HEAD_DIM``, f32 and bf16 (the reference's kernel takes any).

``ROUTES`` picks the route from (dtype, head_dim); nothing is chosen by
catching a failure, and a launch or build error raises. The wrappers take
CUDA tensors only: they check them, allocate the output, launch on
PyTorch's current stream and raise if the launch failed. Each route counts
its own launches (``flash_attention_wgmma.launches``,
``flash_attention_mma.launches``, ``flash_attention_wide.launches``);
``flash_attention.launches`` is the total.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256  # the widest padded width the mma kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _RouteTable(dict):
    """(dtype, head_dim) -> route: listed up to ``MAX_HEAD_DIM``; every
    wider head_dim of a taken dtype is "wide"."""

    def __missing__(self, key):
        dtype, hd = key
        if dtype in _DTYPES and isinstance(hd, int) and hd > MAX_HEAD_DIM:
            return "wide"
        raise KeyError(key)


ROUTES = _RouteTable({
    (dtype, hd): "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "mma"
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


def _kernel(name: str, symbol: str, err_symbol: str):
    if name not in _fns:
        lib = build.load(name)
        fn = getattr(lib, symbol)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, i,
                       ctypes.c_float, ctypes.c_float, p]
        fn.restype = i
        err_str = getattr(lib, err_symbol)
        err_str.argtypes = [i]
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
    out = []
    inner = t.shape[-1]  # packed stride of the next dim out, in elements
    for dim in (2, 1, 0):
        stride = t.stride(dim) if t.shape[dim] > 1 else inner
        if stride * nbytes % 16:
            raise ValueError(f"TMA needs strides of 16-byte multiples; stride "
                             f"{stride} of dim {dim} is {stride * nbytes} bytes")
        out.append(stride)
        inner = stride * t.shape[dim]
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
    """The tensor-core route: bf16 at head_dim 64 or 128, q/k/v readable by
    TMA (else ValueError; nothing goes to another route)."""
    _check(q, k, v)
    if route(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"the wgmma kernel takes bf16 at head_dim 64 or 128, "
                         f"not {q.dtype} at {q.shape[-1]}")
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


flash_attention.launches = 0
flash_attention_mma.launches = 0
flash_attention_wgmma.launches = 0
flash_attention_wide.launches = 0
