"""Shared building blocks, ported from ``repro/models/layers.py``.

Plain functions on tensors and nested parameter dicts with the JAX
package's paths and layouts; layer stacks keep a leading ``[L, ...]`` axis.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# a stacked leaf whose f32 draw would take more bytes than this is drawn a
# layer at a time: llava-next-34b's [60, 7168, 20480] MLP leaves (35.2 GB
# in f32). Every other leaf of the configs (the largest, internlm2-20b's
# MLP leaves, 19.3 GB) is drawn whole, so its random weights stay the bits
# they were.
WHOLE_DRAW_BYTES = 24 << 30


def _init(gen: torch.Generator, shape, scale=None, *, stack: int = 0,
          dtype: torch.dtype = torch.float32):
    """N(0, 1) * scale drawn in f32 on the generator's device and stored in
    ``dtype``; scale defaults to 1/sqrt(shape[0]) (fan-in). ``stack > 0``
    draws that many independent weights of ``shape`` on a leading layer
    axis: in one draw, or one layer at a time into the stacked output where
    the whole f32 draw would exceed ``WHOLE_DRAW_BYTES``. Each draw is
    cast at once, so a model's init holds at most one f32 draw beside its
    weights in ``dtype``. With ``MetaDraws`` in place of the generator,
    nothing is drawn: an empty meta tensor of the same shape and dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = (stack, *shape) if stack else tuple(shape)
    if gen.device.type == "meta":  # ``MetaDraws``: the leaf's stand-in
        return torch.empty(full, dtype=dtype, device="meta")

    def draw(size):
        return torch.randn(size, generator=gen, device=gen.device,
                           dtype=torch.float32).mul_(scale)

    if math.prod(full) * 4 <= WHOLE_DRAW_BYTES:
        return draw(full).to(dtype)
    out = torch.empty(full, dtype=dtype, device=gen.device)
    for w in out:
        w.copy_(draw(tuple(shape)))
    return out


class MetaDraws:
    """Takes a ``torch.Generator``'s place in the init functions: every
    draw (``_init``) and constant (on the generator's device) becomes a
    tensor on the meta device, so an init gives its tree's shapes and
    dtypes and allocates nothing."""

    device = torch.device("meta")


# leaves the reference uses in f32 whatever the compute dtype: RMSNorm
# scales, the SSM's dt bias, decay, skip and gated-norm scale
# (repro/models/ssm.py:154-155, 167, 172), and the MoE router
# (repro/models/moe.py:69): top-k on bf16-rounded router weights would send
# tokens to other experts
F32_LEAVES = frozenset({"scale", "dt_bias", "A_log", "D", "norm_scale", "router"})


def cast_params(tree: Params, dtype: torch.dtype) -> Params:
    """Store every weight once in ``dtype`` (the compute dtype), which rounds
    exactly as the reference's per-use ``.astype(x.dtype)`` does; the leaves
    named in ``F32_LEAVES`` stay f32, since the reference uses them in f32."""
    if isinstance(tree, dict):
        return {k: (v.float() if k in F32_LEAVES else cast_params(v, dtype))
                for k, v in tree.items()}
    return tree.to(dtype)


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked ``[L, ...]`` parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree: Params, unbind=None) -> list[Params]:
    """The layers of a stacked ``[L, ...]`` tree as views, by one ``unbind``
    a leaf (or ``unbind(leaf)``): its backward writes every layer's
    gradient into one stacked tensor, where ``layer(tree, i)`` per layer
    would add ``L`` stack-sized ones."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, unbind) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0) if unbind is None else unbind(tree))


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                dtype: torch.dtype = torch.float32) -> Params:
    return {"w": _init(gen, (d_in, d_out), dtype=dtype)}


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, *,
                stack: int = 0, dtype: torch.dtype = torch.float32) -> Params:
    return {
        "gate": _init(gen, (d, d_ff), stack=stack, dtype=dtype),
        "up": _init(gen, (d, d_ff), stack=stack, dtype=dtype),
        "down": _init(gen, (d_ff, d), stack=stack, dtype=dtype),
    }


def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   dtype: torch.dtype = torch.float32) -> Params:
    return {"table": _init(gen, (vocab, d), scale=0.02, dtype=dtype)}


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm_init(d: int, device=None, *, stack: int = 0) -> Params:
    shape = (stack, d) if stack else (d,)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"]).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved pairs, optional partial rotary)
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                rotary_pct: float = 1.0):
    """f32 cos/sin tables [*, rot_dim/2] for the rotated prefix of head_dim."""
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=positions.device) / rot_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles), rot_dim


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, rot_dim/2].
    Rotates the pairs (x[..., 0::2], x[..., 1::2]), not the two halves."""
    rot, keep = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = rot[..., 0::2], rot[..., 1::2]
    c = cos[..., None, :].to(x.dtype)  # broadcast over heads
    s = sin[..., None, :].to(x.dtype)
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    rotated = torch.stack([y1, y2], dim=-1).reshape(rot.shape)
    return torch.cat([rotated, keep], dim=-1) if keep.shape[-1] else rotated


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["gate"].to(x.dtype)
    u = x @ p["up"].to(x.dtype)
    return (F.silu(g) * u) @ p["down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(p: Params, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # cast the table before the gather, as the reference does
    return F.embedding(tokens, p["table"].to(dtype))


def _f32_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with operands in x's dtype and f32 accumulation and output: a
    bf16 ``torch.matmul`` would round the logits to bf16."""
    return x.float() @ w.to(x.dtype).float()


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x @ table.T, f32 logits."""
    return _f32_logits(x, p["table"].T)


def unembed_separate(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _f32_logits(x, p["w"])


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of f32 ``logits`` [..., vocab]; labels < 0
    are masked (the reference's ``softmax_xent``)."""
    nll, count = softmax_xent_sums(logits, labels)
    return nll / count.clamp_min(1.0)


def softmax_xent_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(summed token cross-entropy, count of unmasked labels) of
    ``softmax_xent``, for a mean over tokens held by several ranks."""
    mask = (labels >= 0).to(torch.float32)
    labels = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()
