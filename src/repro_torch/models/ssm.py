"""Mamba2 / SSD blocks, ported from ``repro/models/ssm.py``: prefill
through the SSD chunked-scan kernel, training through one autograd
function around the scan kernel and its backward kernel, and the
O(1)-per-token recurrent decode in plain torch.

Projections stay separate weight matrices (z/x/B/C/dt), with the
reference's paths and layouts. Dtypes follow the reference: projections
and the prefill conv in the activation dtype, the scan, the D skip and the
gated RMSNorm in f32, decode's conv in f32 on an f32 window.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Params, _init


def ssd_init(gen: torch.Generator, d_model: int, *, expand: int = 2,
             head_dim: int = 64, state: int = 128, conv_width: int = 4,
             stack: int = 0, dtype: torch.dtype = torch.float32) -> Params:
    """The block's weights in ``dtype``; dt_bias, A_log, D and norm_scale
    in f32 (``layers.F32_LEAVES``)."""
    d_inner = expand * d_model
    heads = d_inner // head_dim
    dev = gen.device
    kw = dict(stack=stack, dtype=dtype)

    def const(n: int, value: float) -> torch.Tensor:
        shape = (stack, n) if stack else (n,)
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "w_z": _init(gen, (d_model, d_inner), **kw),
        "w_x": _init(gen, (d_model, d_inner), **kw),
        "w_B": _init(gen, (d_model, state), **kw),
        "w_C": _init(gen, (d_model, state), **kw),
        "w_dt": _init(gen, (d_model, heads), **kw),
        "conv_x": _init(gen, (conv_width, d_inner), scale=0.5, **kw),
        "conv_B": _init(gen, (conv_width, state), scale=0.5, **kw),
        "conv_C": _init(gen, (conv_width, state), scale=0.5, **kw),
        "dt_bias": const(heads, 0.0),
        "A_log": const(heads, 0.0),
        "D": const(heads, 1.0),
        "out_proj": _init(gen, (d_inner, d_model), **kw),
        "norm_scale": const(d_inner, 1.0),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in x's dtype. x: [B, S, C]; w: [K, C]."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i].to(x.dtype)
    return out


def _gated_norm_out(p: Params, y: torch.Tensor, z: torch.Tensor,
                    dtype: torch.dtype, mean_sq=None) -> torch.Tensor:
    """Mamba2's gated RMSNorm (f32) and the output projection. ``mean_sq``
    maps the f32 gated y [.., C] to the mean of its squares over the
    block's whole d_inner, [.., 1]: by default over y's C channels, which
    are all of them unless a tensor-parallel rank holds its heads' share."""
    y = y.to(dtype) * F.silu(z)
    var = (y.float().square().mean(dim=-1, keepdim=True) if mean_sq is None
           else mean_sq(y.float()))
    y = (y.float() * torch.rsqrt(var + 1e-5) * p["norm_scale"]).to(dtype)
    return y @ p["out_proj"].to(dtype)


class _SSDScan(torch.autograd.Function):
    """y = fwd(xh, dt, A, Bm, Cm) with the gradient of bwd(xh, dt, A, Bm,
    Cm, dy): the SSD kernels on the card, their plain versions on the CPU
    (``kernels/ops``). Saves the inputs; the backward recomputes the states
    entering each chunk."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk, fwd, bwd):
        y = fwd(xh, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.chunk, ctx.bwd = chunk, bwd
        return y

    @staticmethod
    def backward(ctx, dy):
        grads = ctx.bwd(*ctx.saved_tensors, dy.contiguous(), chunk=ctx.chunk)
        return (*grads, None, None, None)


def ssd_block(
    p: Params,
    x: torch.Tensor,  # [B, S, d_model]
    *,
    head_dim: int,
    state: int,
    chunk: int,
    conv_width: int = 4,
    scan=kops.ssd_scan,
    scan_bwd=kops.ssd_scan_bwd,
    cache: Params | None = None,
    mean_sq=None,
) -> torch.Tensor:
    """The Mamba2 block over positions 0..S-1; returns [B, S, d_model].
    ``scan`` and ``scan_bwd`` are the SSD scan and its backward (the
    kernels unless a comparison swaps in the plain versions); without a
    cache the scan is one autograd function, whose backward is ``scan_bwd``
    when autograd records the block, as in training. With
    ``cache`` (one layer of an ``init_ssm_cache`` cache), the state after S
    tokens and the last K-1 rows of the three conv inputs are written into
    it, as stepping ``ssd_decode_step`` over the prompt would leave them.
    ``p`` and ``cache`` may hold a tensor-parallel rank's heads alone (its
    w_z, w_x, w_dt and conv_x columns, out_proj rows, per-head leaves and
    state rows); then ``mean_sq`` (``_gated_norm_out``) sums the gated
    norm's squares over every rank, and the output is this rank's part of
    a sum over them."""
    B, S, _ = x.shape
    d_inner = p["out_proj"].shape[0]
    H = d_inner // head_dim

    z = x @ p["w_z"].to(x.dtype)
    proj = {name: x @ p[f"w_{name}"].to(x.dtype) for name in ("x", "B", "C")}
    xin = F.silu(_causal_conv(proj["x"], p["conv_x"]))
    Bm = F.silu(_causal_conv(proj["B"], p["conv_B"]))
    Cm = F.silu(_causal_conv(proj["C"], p["conv_C"]))
    dt_raw = x @ p["w_dt"].to(x.dtype)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,S,H]
    A = -torch.exp(p["A_log"])  # [H] negative
    xh = xin.reshape(B, S, H, head_dim)
    ins = (xh.float(), dt, A, Bm.float(), Cm.float())
    if cache is None:
        y = _SSDScan.apply(*ins, chunk, scan, scan_bwd)
    else:
        y, final = scan(*ins, chunk=chunk, return_state=True)
        cache["state"].copy_(final)
        keep = min(S, conv_width - 1)
        for name in ("x", "B", "C"):
            win = cache[f"conv_{name}"]
            win.zero_()
            if keep:
                win[:, win.shape[1] - keep:] = proj[name][:, S - keep:].float()
    y = y + xh.float() * p["D"][None, None, :, None]
    return _gated_norm_out(p, y.reshape(B, S, d_inner), z, x.dtype, mean_sq)


# ---------------------------------------------------------------------------
# Recurrent decode: O(1) per token
# ---------------------------------------------------------------------------

def init_ssm_cache(batch: int, d_inner: int, head_dim: int, state: int,
                   conv_width: int, device=None, *, stack: int = 0) -> Params:
    """Zero f32 state and conv windows; ``stack > 0`` adds a leading layer
    axis of that many."""
    H = d_inner // head_dim
    lead = (stack,) if stack else ()

    def zeros(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=torch.float32,
                           device=device)

    return {
        "state": zeros(H, head_dim, state),
        "conv_x": zeros(conv_width - 1, d_inner),
        "conv_B": zeros(conv_width - 1, state),
        "conv_C": zeros(conv_width - 1, state),
    }


def _conv_step(cache_win: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """cache_win: [B, K-1, C]; new: [B, C]; w: [K, C] -> (out [B,C], new win),
    in the window's dtype."""
    win = torch.cat([cache_win, new[:, None, :].to(cache_win.dtype)], dim=1)
    out = (win * w[None].to(win.dtype)).sum(1)
    return out, win[:, 1:, :]


def ssd_decode_step(
    p: Params,
    x: torch.Tensor,  # [B, 1, d_model]
    cache: Params,
    *,
    head_dim: int,
    state: int,
    mean_sq=None,
) -> torch.Tensor:
    """One decode step; returns out [B, 1, d_model]. Unlike the reference,
    which returns a new cache, the new state and conv windows are written
    into ``cache`` in place. ``p``, ``cache`` and ``mean_sq`` as in
    ``ssd_block``."""
    B = x.shape[0]
    d_inner = p["out_proj"].shape[0]
    H = d_inner // head_dim

    xt = x[:, 0]
    z = xt @ p["w_z"].to(x.dtype)
    conv = {}
    for name in ("x", "B", "C"):
        out, win = _conv_step(cache[f"conv_{name}"], xt @ p[f"w_{name}"].to(x.dtype),
                              p[f"conv_{name}"])
        conv[name] = F.silu(out)
        cache[f"conv_{name}"].copy_(win)
    dt_raw = xt @ p["w_dt"].to(x.dtype)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])  # [B,H]
    xh = conv["x"].reshape(B, H, head_dim).float()
    dBx = torch.einsum("bn,bhp->bhpn", conv["B"].float(), xh * dt[..., None])
    new_state = cache["state"] * dA[..., None, None] + dBx
    cache["state"].copy_(new_state)
    y = torch.einsum("bhpn,bn->bhp", new_state, conv["C"].float())
    y = y + xh * p["D"][None, :, None]
    return _gated_norm_out(p, y.reshape(B, d_inner), z, x.dtype, mean_sq)[:, None, :]
