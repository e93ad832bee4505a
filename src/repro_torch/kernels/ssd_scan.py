"""Wrappers of the CUDA SSD chunked-scan kernel (csrc/ssd_scan.cu) and of
its backward (csrc/ssd_scan_bwd.cu).

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

``ssd_scan_bwd`` gives the scan's gradients for a cotangent of y, on the
same terms (CUDA f32, any P, N and chunk through ``slice_plan``); it
recomputes the states entering each chunk with the forward's passes (a)
and (b), sizes the backward's scratch by the heads a block that the kernel
picks (``bwd_groups``) and counts its launches in
``ssd_scan_bwd.launches``.

``flops`` is the arithmetic of either direction, which ``kernels/ops``
registers as the FLOP formula of its operators.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)  # built widths of P, N and the chunk; others
STATE_SIZES = (8, 16, 32, 64, 128)  # are cut or padded to them (slice_plan)
MAX_CHUNK = 128
_fns: dict = {}


def _kernel():
    """(the forward, its states-only entry, the error string), bound."""
    if "fwd" not in _fns:
        lib = build.load("ssd_scan")
        p, i, strides = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        fn = lib.repro_ssd_scan_fwd
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides, p]
        fn.restype = i
        states = lib.repro_ssd_scan_states
        states.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, strides, p]
        states.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fns["fwd"] = (fn, states, lib.repro_cuda_error_string)
    return _fns["fwd"]


def _bwd_kernel():
    """(the backward, its group query), bound."""
    if "bwd" not in _fns:
        lib = build.load("ssd_scan_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.repro_ssd_scan_bwd
        fn.argtypes = [p] * 20 + [i] * 8 + [p]
        fn.restype = i
        groups = lib.repro_ssd_scan_bwd_groups
        groups.argtypes = [i] * 6 + [ctypes.POINTER(i)]
        groups.restype = i
        _fns["bwd"] = (fn, groups)
    return _fns["bwd"]


_bwd_groups: dict = {}


def bwd_groups(device, B, S, H, P, N, chunk) -> tuple[int, int, int]:
    """``(g_rev, g_chunk, rq_rows)`` of the backward's kernel at this shape
    on ``device``: the heads a block of its reverse-state pass and of its
    chunk and dB/dC passes, chosen by the kernel from the grid and the
    card's SMs, and the rows of its per-position scratch rq, which the
    caller allocates; built sizes only."""
    key = (device, B, S, H, P, N, chunk)
    if key not in _bwd_groups:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            err = _bwd_kernel()[1](B, S, H, P, N, int(chunk), out)
        if err != 0:
            raise RuntimeError(f"ssd_scan_bwd group query failed: "
                               f"{_kernel()[2](err).decode()} ({err})")
        _bwd_groups[key] = (out[0], out[1], out[2])
    return _bwd_groups[key]


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
    fn, _, err_str = _kernel()
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


def _check_card(named) -> None:
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}.dtype {t.dtype}; the kernel takes float32")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("the SSD scan's tensors must be on one device")


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             state_out: torch.Tensor | None = None) -> torch.Tensor:
    """xh [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,N] -> y [B,S,H,P] on the
    card, at any P, N and chunk (``slice_plan``); ``state_out`` [B,H,P,N]
    f32 (contiguous) receives the final state."""
    named = (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    if state_out is not None:
        named += (("state_out", state_out),)
    _check_card(named)
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


def _bwd_launch(xh, dt, A, Bm, Cm, dy, chunk):
    """One backward at built sizes (P in HEAD_DIMS, N in STATE_SIZES, chunk
    <= MAX_CHUNK), contiguous tensors. Returns (dxh, ddt, dA, dBm, dCm)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc, qp = -(-S // chunk), -(-chunk // 16) * 16

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xh.device)

    g_rev, g_chunk, rq_rows = bwd_groups(xh.device, B, S, H, P, N, chunk)
    states = scratch(B, H, nc, P, N) if nc > 1 else scratch(0)
    totals, rev = scratch(B, H, nc), torch.empty_like(states)
    scores, dA_part = scratch(B, nc, qp, qp), scratch(B, nc, H)
    wsum, rq = scratch(B, nc, H // g_chunk, 2, qp, qp), scratch(rq_rows, B, H, S)
    dB_part, dC_part = scratch(B, H // g_chunk, S, N), scratch(B, H // g_chunk, S, N)
    out = [torch.empty_like(t) for t in (xh, dt, A, Bm, Cm)]
    _, states_fn, err_str = _kernel()
    fn = _bwd_kernel()[0]
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = 0
        if nc > 1:  # the states entering each chunk: the forward's passes (a), (b)
            strides = (ctypes.c_longlong * 7)(*xh.stride()[:3], *dt.stride()[:2],
                                              *Bm.stride()[:2])
            err = states_fn(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                            states.data_ptr(), totals.data_ptr(), B, S, H, P, N,
                            int(chunk), strides, stream)
        if err == 0:
            err = fn(*(t.data_ptr() for t in (xh, dt, A, Bm, Cm, dy, states, totals, rev,
                                               scores, wsum, rq, dB_part, dC_part, dA_part,
                                               *out)),
                     B, S, H, P, N, int(chunk), g_rev, g_chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    ssd_scan_bwd.launches += 1
    return tuple(out)


def _sliced_bwd(xh, dt, A, Bm, Cm, dy, chunk, launch):
    """The backward at any (P, N, chunk) through ``launch`` at built sizes,
    by ``slice_plan``: dx of each P slice sums over the N slices, dB and dC
    of each N slice over the P slices, ddt and dA over all (each slice is
    the scan of its own x columns and state columns). One launch when P and
    N are built sizes."""
    P, N = xh.shape[-1], Bm.shape[-1]
    p_cuts, n_cuts, run_chunk = slice_plan(P, N, chunk)
    if len(p_cuts) == len(n_cuts) == 1 and p_cuts[0][2] == P and n_cuts[0][2] == N:
        return launch(xh, dt, A, Bm, Cm, dy, run_chunk)
    dx, ddt, dA = torch.zeros_like(xh), torch.zeros_like(dt), torch.zeros_like(A)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    for p_lo, p_hi, pw in p_cuts:
        x_s = _pad_last(xh, p_lo, p_hi, pw).contiguous()
        dy_s = _pad_last(dy, p_lo, p_hi, pw).contiguous()
        for n_lo, n_hi, nw in n_cuts:
            gx, gdt, gA, gB, gC = launch(
                x_s, dt, A, _pad_last(Bm, n_lo, n_hi, nw).contiguous(),
                _pad_last(Cm, n_lo, n_hi, nw).contiguous(), dy_s, run_chunk)
            dx[..., p_lo:p_hi] += gx[..., :p_hi - p_lo]
            ddt += gdt
            dA += gA
            dB[..., n_lo:n_hi] += gB[..., :n_hi - n_lo]
            dC[..., n_lo:n_hi] += gC[..., :n_hi - n_lo]
    return dx, ddt, dA, dB, dC


def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 128):
    """(dxh, ddt, dA, dBm, dCm) of ``ssd_scan(xh, dt, A, Bm, Cm)`` = y for
    the cotangent ``dy`` [B,S,H,P] of y, on the card, at any P, N and chunk
    (``slice_plan``). Every sum (over heads for dB and dC, over batch and
    positions for dA) is taken in a fixed order: two calls give the same
    bits."""
    named = (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("dy", dy))
    _check_card(named)
    if dy.shape != xh.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be shaped as xh {tuple(xh.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be positive")
    xh, dt, A, Bm, Cm, dy = (t.contiguous() for t in (xh, dt, A, Bm, Cm, dy))
    if xh.numel() == 0 or Bm.shape[-1] == 0:
        return tuple(torch.zeros_like(t) for t in (xh, dt, A, Bm, Cm))
    return _sliced_bwd(xh, dt, A, Bm, Cm, dy, chunk, _bwd_launch)


ssd_scan_bwd.launches = 0


def flops(xh_shape, N: int, chunk: int, *, backward: bool = False) -> int:
    """The products of the chunked scan over xh [B, S, H, P] with a state of
    N, at the chunk the kernel runs (``min(chunk, MAX_CHUNK)``), the last
    chunk holding what is left of S. For a chunk of q positions with
    pairs = q (q + 1) / 2 causal (i, j) pairs, 2 FLOPs a multiply-add:

    forward: the scores C B^T over the pairs once per (b, chunk), since B
    and C, and so the scores, are shared by all heads (pairs N 2); per
    (b, h, chunk) the scores' product with x dt over the pairs (pairs P 2),
    the chunk's state B^T (x dt decay) and its read C h_in^T (q N P 2 each).

    backward: per (b, chunk) over the pairs C B^T recomputed and the
    intra-chunk parts of dB and dC, Wsum^T C and Wsum B, with Wsum the
    heads' W = dy x^T o L summed (H adds a pair); per (b, h, chunk) dy x^T
    and (C B^T o L)^T dy over the pairs, and the products of q x P x N the
    function needs: the chunk's state (the forward's, recomputed), B carry^T
    and x carry in every chunk but the last (the last chunk's state is read
    by nothing and its carry is 0), the reverse state dy^T C and dy h_in in
    every chunk but the first (its entering state is 0).

    The state's walk across chunks (P N a chunk and head), the decays'
    exponentials and the other elementwise work are not counted."""
    B, S, H, P = xh_shape
    Q = max(1, min(chunk, MAX_CHUNK))
    nc = -(-S // Q)
    total = 0
    for c in range(nc):
        q = min(Q, S - c * Q)
        pairs = q * (q + 1) // 2
        if backward:
            products = 3 * (c < nc - 1) + 2 * (c > 0)
            total += B * (3 * pairs * N * 2 + H * pairs
                          + H * (2 * pairs * P * 2 + products * q * P * N * 2))
        else:
            total += B * (pairs * N * 2 + H * (pairs * P * 2 + 2 * q * N * P * 2))
    return total
