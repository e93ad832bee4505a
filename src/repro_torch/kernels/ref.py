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
