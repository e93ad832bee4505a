"""AdamW with decoupled weight decay, global-norm clipping and a cosine LR
schedule, ported from ``repro/optim/adamw.py``.

Params, gradients and moments are nested dicts of tensors with the
reference's names; the moments are f32. Unlike the reference's pure
functions, ``adamw_update`` updates the params and the state in place (and
returns them), so a full-width model needs no second copy of either.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.bridge import named_leaves
from repro_torch.models.layers import Params


@dataclass
class AdamWState:
    step: int
    mu: Any  # first moment, params-shaped, f32
    nu: Any  # second moment, params-shaped, f32


def _zeros_like(tree: Params) -> Params:
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


def adamw_init(params: Params) -> AdamWState:
    return AdamWState(0, _zeros_like(params), _zeros_like(params))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> lr, a 0-d f32 tensor: linear warm-up, then a cosine decay
    to 0 at ``total``, computed in f32 as the reference does."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def global_norm(grads: Params) -> torch.Tensor:
    """The L2 norm of every gradient leaf together, f32."""
    sq = sum(g.float().square().sum() for _, g in named_leaves(grads))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)

    def scaled(tree):
        if isinstance(tree, dict):
            return {k: scaled(v) for k, v in tree.items()}
        return (tree * scale).to(tree.dtype)

    return scaled(grads), gnorm


_DECAY_EXEMPT = ("scale", "dt_bias", "A_log", "D", "norm_scale")


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """Returns (params, state, metrics), the params and the state updated in
    place. ``lr`` is a schedule (step -> lr) or a float. The gradients are
    clipped by their global norm first; decay applies to leaves of ndim >= 2
    whose name holds none of ``_DECAY_EXEMPT``, as in the reference."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_grad_norm).to(gnorm.device)
    state.step += 1
    step = torch.tensor(float(state.step), dtype=torch.float32)
    lr_t = lr(state.step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** step)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** step)
    leaves = zip(named_leaves(params), named_leaves(grads), named_leaves(state.mu),
                 named_leaves(state.nu))
    for (path, p), (_, g), (_, mu), (_, nu) in leaves:
        g32 = (g * scale.to(g.device)).to(g.dtype).float()
        mu.mul_(b1).add_((1 - b1) * g32)
        nu.mul_(b2).add_((1 - b2) * g32.square())
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        name = path[-1]
        if weight_decay > 0 and p.ndim >= 2 and not any(t in name for t in _DECAY_EXEMPT):
            update = update + weight_decay * p.float()
        p.copy_((p.float() - lr_t.to(p.device) * update).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
