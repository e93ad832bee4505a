"""Plain PyTorch versions of the kernels: the CPU path of the port and the
oracle each CUDA kernel is held against on the card.

Deliberately naive (dense scores), independent of the kernels' tile walks.
"""

from __future__ import annotations

import math

import torch


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
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # rows with no visible key
    out = torch.einsum("bhst,bthd->bshd", p, vv.float())
    return out.to(q.dtype)
