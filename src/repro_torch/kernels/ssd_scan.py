"""Wrapper of the CUDA SSD chunked-scan kernel (csrc/ssd_scan.cu).

Replaces ``repro/kernels/ssd_scan.py:ssd_scan`` (Pallas). Takes CUDA f32
tensors only: it checks them, allocates the output and the kernel's scratch
(each chunk's state, [B, H, nc, P, N], and its total decay, [B, H, nc]),
launches the kernel's passes on PyTorch's current stream and raises if a
launch failed. With ``state_out`` it also writes the f32 state after the
last position there. The kernel is built for P in ``HEAD_DIMS``, N in
``STATE_SIZES`` and chunks up to ``MAX_CHUNK``; the wrapper takes any P, N
and chunk, as the reference does, by cutting or padding them to those
sizes (``slice_plan`` says why each step is exact), always through the
kernel. Counts its launches in ``ssd_scan.launches``: one a call at built
sizes, one for each (P slice, N slice) otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)  # built widths of P, N and the chunk; others
STATE_SIZES = (8, 16, 32, 64, 128)  # are cut or padded to them (slice_plan)
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


def slice_plan(P: int, N: int, chunk: int):
    """How the kernel covers any (P, N, chunk) with its built widths:
    (P slices, N slices, chunk to run), each slice ``(lo, hi, width)`` with
    ``width`` a built size >= hi - lo (the slice is zero-padded up to it).

    Each step is exact, so the result is the scan's at the asked sizes:
    - P: the columns of x are independent (y[..., p] and the state's row p
      depend on x[..., p] alone), so P is cut into slices of at most 64,
      each padded with zero columns, whose y and state rows are 0 and are
      dropped;
    - N: the state's columns evolve independently (column n only sees
      B[..., n]) and y = sum_n state[:, n] C[n] is linear in them, so N is
      cut into slices of at most 128 whose y are summed and whose states
      fill the state's columns; a slice padded with zero columns of B and C
      keeps those state columns at 0 and adds nothing to y;
    - chunk: the chunked form gives the same y and state for every chunk
      length, so a chunk above ``MAX_CHUNK`` runs at ``MAX_CHUNK``."""
    if P < 1 or N < 1 or chunk < 1:
        raise ValueError(f"P, N and chunk must be positive; got {P}, {N}, {chunk}")

    def cut(total, sizes):
        if total in sizes:
            return [(0, total, total)]
        step = sizes[-1]
        return [(lo, min(lo + step, total),
                 next(w for w in sizes if w >= min(step, total - lo)))
                for lo in range(0, total, step)]

    return cut(P, HEAD_DIMS), cut(N, STATE_SIZES), min(chunk, MAX_CHUNK)


def _pad_last(t: torch.Tensor, lo: int, hi: int, width: int) -> torch.Tensor:
    """Columns lo:hi of the last dim, zero-padded to ``width`` (a view when
    no padding is needed)."""
    t = t[..., lo:hi]
    return t if hi - lo == width else torch.nn.functional.pad(t, (0, width - (hi - lo)))


def _launch(xh, dt, A, Bm, Cm, chunk, state_out):
    """One launch at built sizes: P in HEAD_DIMS, N in STATE_SIZES, chunk
    <= MAX_CHUNK. Returns y."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    y = torch.empty_like(xh, memory_format=torch.contiguous_format)
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


def _sliced(xh, dt, A, Bm, Cm, chunk, state_out, launch):
    """The scan at any (P, N, chunk) through ``launch`` at built sizes, by
    ``slice_plan``. One launch, on the tensors as given, when P and N are
    built sizes."""
    P, N = xh.shape[-1], Bm.shape[-1]
    p_cuts, n_cuts, run_chunk = slice_plan(P, N, chunk)
    if len(p_cuts) == len(n_cuts) == 1 and p_cuts[0][2] == P and n_cuts[0][2] == N:
        return launch(xh, dt, A, Bm, Cm, run_chunk, state_out)
    B, S, H, _ = xh.shape
    y = torch.zeros_like(xh, memory_format=torch.contiguous_format)
    for p_lo, p_hi, pw in p_cuts:
        x_s = _pad_last(xh, p_lo, p_hi, pw)
        for n_lo, n_hi, nw in n_cuts:
            st = None if state_out is None else torch.empty(
                (B, H, pw, nw), dtype=torch.float32, device=xh.device)
            y_s = launch(x_s, dt, A, _pad_last(Bm, n_lo, n_hi, nw),
                         _pad_last(Cm, n_lo, n_hi, nw), run_chunk, st)
            y[..., p_lo:p_hi] += y_s[..., :p_hi - p_lo]
            if st is not None:
                state_out[:, :, p_lo:p_hi, n_lo:n_hi] = st[:, :, :p_hi - p_lo, :n_hi - n_lo]
    return y


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             state_out: torch.Tensor | None = None) -> torch.Tensor:
    """xh [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,N] -> y [B,S,H,P] on the
    card, at any P, N and chunk (``slice_plan``); ``state_out`` [B,H,P,N]
    f32 (contiguous) receives the final state."""
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
    if A.ndim != 1 or not A.is_contiguous():
        raise ValueError("A must be a contiguous [H] tensor")
    if state_out is not None and (state_out.shape != (B, H, P, N)
                                  or not state_out.is_contiguous()):
        raise ValueError(f"state_out must be a contiguous {(B, H, P, N)} tensor")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be positive")
    if xh.numel() == 0 or N == 0:
        if state_out is not None:
            state_out.zero_()
        return torch.zeros_like(xh, memory_format=torch.contiguous_format)
    return _sliced(xh, dt, A, Bm, Cm, chunk, state_out, _launch)


ssd_scan.launches = 0
