"""Plain PyTorch versions of the kernels: the CPU path of the port and the
oracle each CUDA kernel is held against on the card.

Deliberately naive (dense scores; the token-by-token SSD recurrence),
independent of the kernels' tile walks.
"""

from __future__ import annotations

import math

import torch


def _visible(S: int, T: int, causal: bool, window: int, device) -> torch.Tensor:
    """[S, T] bool: the (query, key) pairs the causal / sliding-window masks
    leave visible."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Dense GQA attention. q: [B,S,H,hd]; k/v: [B,T,KV,hd] -> [B,S,H,hd].

    Port of ``repro/kernels/ref.py:flash_attention_ref``: f32 scores and
    softmax, scale 1/sqrt(hd), tanh softcap before the causal / sliding-window
    masks, output in q's dtype. A row with no visible key gives 0, as the
    kernel does (the JAX oracle never meets one)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV
    kk = k.repeat_interleave(group, dim=2)  # [B,T,H,hd]
    vv = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kk.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~_visible(S, T, causal, window, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # rows with no visible key
    out = torch.einsum("bhst,bthd->bshd", p, vv.float())
    return out.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, dout, *, causal=True, window=0, softcap=0.0):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v)`` = o for the cotangent
    ``dout``, dense and in f32, outputs in the inputs' dtypes: the plain
    version of the backward kernel. The function of the reference's
    ``_flash_bwd_vjp`` (repro/models/attention.py:227): P recomputed from
    q and k, D = rowsum(dout o) from the given o, dS = P (dout V^T - D)
    (1 - tanh^2 under the softcap) / sqrt(hd), dq = dS K, dk = dS^T Q and
    dv = P^T dout summed over the query heads of each kv head. Rows with
    no visible key give zero."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV
    qf, of, df = q.float(), o.float(), dout.float()
    kk = k.float().repeat_interleave(group, dim=2)  # [B,T,H,hd]
    vv = v.float().repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bshd,bthd->bhst", qf, kk) * scale
    if softcap > 0.0:
        tanh_s = torch.tanh(s / softcap)
        s = softcap * tanh_s
    s = s.masked_fill(~_visible(S, T, causal, window, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # rows with no visible key
    dp = torch.einsum("bshd,bthd->bhst", df, vv)
    delta = (df * of).sum(-1).transpose(1, 2)  # [B,H,S]
    ds = p * (dp - delta[..., None])
    if softcap > 0.0:
        ds = ds * (1.0 - tanh_s * tanh_s)
    ds = ds * scale
    dq = torch.einsum("bhst,bthd->bshd", ds, kk)
    dk = torch.einsum("bhst,bshd->bthd", ds, qf).reshape(B, T, KV, group, hd).sum(3)
    dv = torch.einsum("bhst,bshd->bthd", p, df).reshape(B, T, KV, group, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_scan_ref(xh, dt, A, Bm, Cm, *, chunk=128, return_state=False):
    """Token-by-token SSD recurrence (the definitional form), a port of
    ``repro/kernels/ref.py:ssd_scan_ref``:

        h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t

    xh: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (< 0); Bm/Cm: [B,S,N].
    Returns y [B,S,H,P] in xh's dtype, and with ``return_state`` also the f32
    state after the last position, [B,H,P,N]. ``chunk`` is accepted for the
    kernel's signature and does not change the result."""
    del chunk
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    x, d = xh.float(), dt.float()
    b, c, a = Bm.float(), Cm.float(), A.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        decay = torch.exp(d[:, t] * a[None, :])  # [B,H]
        dbx = torch.einsum("bn,bhp->bhpn", b[:, t], x[:, t] * d[:, t, :, None])
        h = h * decay[..., None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    y = (torch.stack(ys, dim=1) if ys else torch.zeros_like(x)).to(xh.dtype)
    return (y, h) if return_state else y


def ssd_chunked_ref(xh, dt, A, Bm, Cm, *, chunk=128):
    """The chunked SSD scan in f32, differentiable by autograd: a port of
    the reference's ``repro/models/ssm.py:_ssd_chunked`` (without its
    sharding ``policy``), whose autodiff is how the reference trains the
    scan. Same shapes as ``ssd_scan_ref``; returns y [B,S,H,P] in f32.

    Three departures, none of which changes y where the reference's is
    finite: the prefix sums of dt*A are taken in f64 (they reach ~-100 over
    a chunk of 128, where an f32 sum is off by ~1e-5 of that); the decay
    exp(csum_i - csum_j) is masked before the exp, not after, so that its
    gradient is 0 above the diagonal, where exp of a difference above ~88
    overflows to inf and the reference's gradient reads inf * 0 = nan; and
    S need not be a multiple of the chunk (the sequence is zero-padded,
    dt = x = B = C = 0, which adds nothing and is dropped)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = max(1, min(chunk, S))
    pad = -S % Q
    x, d, b, c = xh.float(), dt.float(), Bm.float(), Cm.float()
    if pad:
        x, b, c = (torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                   for t in (x, b, c))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad))
    nc = (S + pad) // Q
    x_ = (x * d[..., None]).reshape(B, nc, Q, H, P)
    dA = (d * A.float()).reshape(B, nc, Q, H)
    Bc, Cc = b.reshape(B, nc, Q, N), c.reshape(B, nc, Q, N)

    csum = torch.cumsum(dA.double(), dim=2)  # [B, nc, Q, H]
    total = csum[:, :, -1, :]  # [B, nc, H]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()[..., None]
    diff = csum[:, :, :, None, :] - csum[:, :, None, :, :]  # [B, nc, Q, Q, H]
    L = torch.exp(diff.masked_fill(~lower, float("-inf"))).float()
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, x_)

    decay_to_end = torch.exp(total[:, :, None, :] - csum).float()  # [B, nc, Q, H]
    chunk_state = torch.einsum("bcjn,bcjhp->bchpn", Bc, x_ * decay_to_end[..., None])
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    states_in = []
    for ci in range(nc):  # the state entering each chunk
        states_in.append(state)
        state = state * torch.exp(total[:, ci]).float()[..., None, None] + chunk_state[:, ci]
    inter = torch.einsum("bcin,bchpn->bcihp", Cc, torch.stack(states_in, 1))
    y = intra + inter * torch.exp(csum).float()[..., None]
    return y.reshape(B, nc * Q, H, P)[:, :S]


def ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy, *, chunk=128):
    """(dxh, ddt, dA, dBm, dCm) of ``ssd_scan(xh, dt, A, Bm, Cm)`` = y for
    the cotangent ``dy`` of y: ``torch.autograd.grad`` through
    ``ssd_chunked_ref``, in f32 and then the inputs' dtypes. The plain
    version of the SSD backward kernel, and the function of the reference's
    autodiff of ``_ssd_chunked`` (repro/models/ssm.py:61)."""
    ins = (xh, dt, A, Bm, Cm)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in ins]
        y = ssd_chunked_ref(*leaves, chunk=chunk)
        grads = torch.autograd.grad(y, leaves, dy.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, ins))
