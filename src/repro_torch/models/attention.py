"""GQA attention, ported from ``repro/models/attention.py``: prefill through
the flash-attention kernel, training through the forward and backward
flash kernels in one autograd function, and decode against a KV cache in
plain torch; the encoder-decoder family's cross-attention the same three
ways."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Params, _init, apply_rope, rope_tables


def attention_init(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, *, stack: int = 0,
                   dtype: torch.dtype = torch.float32) -> Params:
    kw = dict(stack=stack, dtype=dtype)
    return {
        "wq": _init(gen, (d_model, num_heads * head_dim), **kw),
        "wk": _init(gen, (d_model, num_kv_heads * head_dim), **kw),
        "wv": _init(gen, (d_model, num_kv_heads * head_dim), **kw),
        "wo": _init(gen, (num_heads * head_dim, d_model), **kw),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def gqa_scores_mask(seq_q: int, seq_k: int, *, causal: bool, window: int = 0,
                    offset: int = 0, device=None) -> torch.Tensor:
    """[seq_q, seq_k] additive f32 mask; ``offset`` is the absolute position
    of query 0; window > 0 is sliding-window attention."""
    qpos = torch.arange(seq_q, device=device) + offset
    kpos = torch.arange(seq_k, device=device)
    ok = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, float("-inf"))


def attend(q, k, v, mask, *, softcap: float = 0.0):
    """q: [B,S,H,hd], k/v: [B,T,KV,hd] -> [B,S,H,hd]. GQA by head grouping;
    scores in the operands' dtype, then softmax in f32, probabilities cast to
    v's dtype before the PV product (as the reference does)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.to(dt).reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(dt)).float()
    scores = scores / math.sqrt(hd)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + mask  # mask broadcasts [S,T]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, *, num_heads,
         num_kv_heads, head_dim, rope_theta, rotary_pct):
    q = _split_heads(x @ p["wq"].to(x.dtype), num_heads, head_dim)
    k = _split_heads(x @ p["wk"].to(x.dtype), num_kv_heads, head_dim)
    v = _split_heads(x @ p["wv"].to(x.dtype), num_kv_heads, head_dim)
    cos, sin, rot = rope_tables(positions, head_dim, rope_theta, rotary_pct)
    return apply_rope(q, cos, sin, rot), apply_rope(k, cos, sin, rot), v


def self_attention(p: Params, x: torch.Tensor, *, num_heads, num_kv_heads, head_dim,
                   rope_theta, rotary_pct, causal, window, softcap, attention,
                   attention_bwd=None, kv_heads=None):
    """(out [B,S,d], rotated k [B,S,KV,hd], v) of full-sequence attention at
    positions 0..S-1: through ``attention`` alone, or with ``attention_bwd``
    through ``flash_attention_train``. ``num_kv_heads`` counts the KV heads
    of ``p``'s wk/wv columns; ``kv_heads`` (a slice or an index list) picks
    the ones the query heads read, where ``p`` is a tensor-parallel rank's
    share: its query heads' wq columns and wo rows, and every KV head."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, torch.arange(S, device=x.device), num_heads=num_heads,
                   num_kv_heads=num_kv_heads, head_dim=head_dim,
                   rope_theta=rope_theta, rotary_pct=rotary_pct)
    kq, vq = (k, v) if kv_heads is None else (k[:, :, kv_heads], v[:, :, kv_heads])
    if attention_bwd is None:
        out = attention(q, kq, vq, causal=causal, window=window, softcap=softcap)
    else:
        out = flash_attention_train(q, kq, vq, causal=causal, window=window,
                                    softcap=softcap, attention=attention,
                                    attention_bwd=attention_bwd)
    return out.reshape(B, S, num_heads * head_dim) @ p["wo"].to(x.dtype), k, v


def attention_prefill(
    p: Params,
    x: torch.Tensor,  # [B, S, d]
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    rotary_pct: float = 1.0,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    attention=kops.flash_attention,
):
    """Full-sequence attention at positions 0..S-1 through the flash kernel
    (the ``use_flash`` branch of the reference's ``attention_train``).
    Returns (out [B,S,d], rotated k [B,S,KV,hd], v [B,S,KV,hd]) so that a
    caller can fill a KV cache. ``attention`` swaps the kernel for another
    function of the same signature (the plain version, in comparisons)."""
    return self_attention(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                          head_dim=head_dim, rope_theta=rope_theta, rotary_pct=rotary_pct,
                          causal=causal, window=window, softcap=softcap, attention=attention)


class _FlashAttention(torch.autograd.Function):
    """o = fwd(q, k, v) with the gradient of bwd(q, k, v, o, do): the flash
    kernels on the card, their plain versions on the CPU (``kernels/ops``).
    Saves q, k, v and o; the backward recomputes the probabilities. Under a
    sharding policy q, k and v are a rank's local heads, plain tensors: the
    DTensor steps around it stay outside, in autograd's graph."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, fwd, bwd):
        o = fwd(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        ctx.bwd = bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, do.contiguous(), **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_train(q, k, v, *, causal=True, window=0, softcap=0.0,
                          attention=kops.flash_attention,
                          attention_bwd=kops.flash_attention_bwd):
    """Differentiable attention [B,S,H,hd] x [B,T,KV,hd]^2 -> [B,S,H,hd]
    through ``attention`` forward and ``attention_bwd`` backward."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, attention,
                                 attention_bwd)


def attention_train(
    p: Params,
    x: torch.Tensor,  # [B, S, d]
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    rotary_pct: float = 1.0,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    attention=kops.flash_attention,
    attention_bwd=kops.flash_attention_bwd,
) -> torch.Tensor:
    """Training attention at positions 0..S-1: out [B,S,d], differentiable.
    The reference's train path (``attend`` up to S = 2048, its blockwise
    custom VJP beyond) becomes one autograd function around the flash
    kernels at every S. ``attention`` / ``attention_bwd`` swap the kernels
    for the plain versions in comparisons."""
    return self_attention(p, x, num_heads=num_heads, num_kv_heads=num_kv_heads,
                          head_dim=head_dim, rope_theta=rope_theta, rotary_pct=rotary_pct,
                          causal=causal, window=window, softcap=softcap,
                          attention=attention, attention_bwd=attention_bwd)[0]


def local_kv_heads(num_heads: int, num_kv_heads: int, first: int, count: int):
    """Which KV heads query heads ``first .. first + count - 1`` read (head h
    reads KV head h // (H / KV)), for a rank that holds every KV head: a
    slice where they read equal contiguous groups, else an index a query
    head."""
    g = num_heads // num_kv_heads
    kv = [h // g for h in range(first, first + count)]
    n = kv[-1] - kv[0] + 1
    if count % n == 0 and kv == [kv[0] + j // (count // n) for j in range(count)]:
        return slice(kv[0], kv[0] + n)
    return kv


def attention_scores_partial(q, k, v, mask, *, softcap: float = 0.0):
    """One rank's share of decode attention over its slice of the cache
    positions (flash decoding): (o [B,S,H,hd] f32 unnormalised, m [B,S,H]
    the running max, l [B,S,H] the sum of exp(s - m)); slices combine by
    rescaling each with exp(m_i - max m). A slice whose positions are all
    masked gives m = -inf, l = 0, o = 0."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.to(dt).reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(dt)).float() / math.sqrt(hd)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + mask
    m = scores.amax(-1)  # [B, KV, g, S]
    e = torch.exp(scores - torch.where(torch.isinf(m), 0.0, m)[..., None])
    o = torch.einsum("bkgst,btkh->bskgh", e, v.float()).reshape(B, S, H, hd)
    return o, m.permute(0, 3, 1, 2).reshape(B, S, H), e.sum(-1).permute(0, 3, 1, 2).reshape(B, S, H)


def attention_decode(
    p: Params,
    x: torch.Tensor,  # [B, 1, d] current-token activations
    cache: Params,  # {"k","v"}: [B, T, KV, hd], updated in place
    pos: int,  # current absolute position (same for the batch)
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    rotary_pct: float = 1.0,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One decode step; returns out [B,1,d]. Unlike the reference, which
    returns a new cache, the token's k/v are written into ``cache`` in place.
    With window > 0 the cache is a ring buffer of size ``window``."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    q, k, v = _qkv(p, x, torch.full((1,), pos, device=x.device),
                   num_heads=num_heads, num_kv_heads=num_kv_heads,
                   head_dim=head_dim, rope_theta=rope_theta,
                   rotary_pct=rotary_pct)
    slot = pos % T if window > 0 else pos  # ring buffer under SWA
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    if window > 0:
        kpos = torch.arange(T, device=x.device)
        valid = (kpos <= pos % T) | (pos >= T)  # ring full -> all valid
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(valid, zero, float("-inf"))[None, :]
    else:
        mask = gqa_scores_mask(1, T, causal=True, offset=pos, device=x.device)
    out = attend(q, cache["k"], cache["v"], mask, softcap=softcap).to(x.dtype)
    return out.reshape(B, 1, num_heads * head_dim) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Cross attention (the encdec family's decoder over the encoder's output)
# ---------------------------------------------------------------------------

def encode_cross_kv(p: Params, enc_out: torch.Tensor, *, num_kv_heads: int,
                    head_dim: int):
    """One decoder layer's cross-attention k and v of the encoder output
    [B,T,d]: ([B,T,KV,hd], [B,T,KV,hd]), no RoPE."""
    k = _split_heads(enc_out @ p["wk"].to(enc_out.dtype), num_kv_heads, head_dim)
    v = _split_heads(enc_out @ p["wv"].to(enc_out.dtype), num_kv_heads, head_dim)
    return k, v


def cross_attention(
    p: Params,
    x: torch.Tensor,  # [B, S, d] decoder activations
    enc_kv: tuple[torch.Tensor, torch.Tensor],  # ([B,T,KV,hd], [B,T,KV,hd])
    *,
    num_heads: int,
    head_dim: int,
    attention=None,
    attention_bwd=None,
) -> torch.Tensor:
    """Every decoder query over every encoder frame: no RoPE on either side
    and no mask, the function of the reference's ``cross_attention`` (its
    ``attend`` with an all-zero [S, T] mask). Returns out [B,S,d]. With
    ``attention``, q goes through it with causal=False at T != S (prefill);
    with ``attention_bwd`` too, through ``flash_attention_train`` (the
    loss); with neither, through ``attend`` (decode over the cached k/v)."""
    B, S, _ = x.shape
    q = _split_heads(x @ p["wq"].to(x.dtype), num_heads, head_dim)
    k, v = enc_kv
    if attention is None:
        mask = torch.zeros((S, k.shape[1]), dtype=torch.float32, device=x.device)
        out = attend(q, k, v, mask).to(x.dtype)
    elif attention_bwd is None:
        out = attention(q, k, v, causal=False)
    else:
        out = flash_attention_train(q, k, v, causal=False, attention=attention,
                                    attention_bwd=attention_bwd)
    return out.reshape(B, S, num_heads * head_dim) @ p["wo"].to(x.dtype)
