"""Carry parameters between the JAX package and the port, through numpy.

The port never sees jax: a caller converts the reference's param pytree to
numpy first (``jax.tree.map(np.asarray, params)``) and hands it over, and
takes the port's back as numpy leaves under the same names.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import Params, cast_params


def params_from_jax(tree: Params, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> Params:
    """A numpy param pytree of ``repro``'s LM -> the port's params under the
    same dict paths (``embed.table``, ``layers.attn.wq`` [L, d, H*hd], ...).
    Weights are stored in ``dtype``; the f32 leaves of ``cast_params``
    (norm scales, the SSM's dt_bias, A_log and D) stay f32."""
    dev = resolve_device(device)

    def to_torch(t):
        if isinstance(t, dict):
            return {k: to_torch(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, dtype=np.float32)).to(dev)

    return cast_params(to_torch(tree), dtype)


def named_leaves(tree: Params, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(key path, leaf) of every leaf of a nested dict, keys sorted at each
    level: the order in which jax flattens the same dict pytree."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in named_leaves(tree[k], (*prefix, k))]
    return [(prefix, tree)]


def params_to_numpy(tree: Params) -> Params:
    """The port's params -> a nested dict of f32 numpy arrays under the same
    names (``embed.table``, ``layers.attn.wq`` [L, d, H*hd], ...), as
    ``jax.tree.map(np.asarray, params)`` gives the reference's."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()


def head_positions(num_heads: int, padded_heads: int, num_kv_heads: int) -> list[int]:
    """Where each real query head sits among ``padded_heads``: within each
    KV group its real heads first, then its pad heads, so that head h of
    the padded model still reads KV head h // (padded / KV) = its own."""
    if padded_heads % num_kv_heads or num_heads % num_kv_heads or padded_heads < num_heads:
        raise ValueError(f"cannot pad {num_heads} heads to {padded_heads} over "
                         f"{num_kv_heads} KV heads")
    g, gp = num_heads // num_kv_heads, padded_heads // num_kv_heads
    return [(h // g) * gp + h % g for h in range(num_heads)]


def pad_head_params(params: Params, cfg, padded_cfg, *, experts: int | None = None,
                    positions: list[int] | None = None) -> Params:
    """An unpadded model's params carried into ``padded_cfg``
    (``launch.sharding.pad_heads(cfg, tp)``) so that the padded model
    computes the same function: every attention block's ``wq`` gets zero
    columns and its ``wo`` zero rows for the pad heads, laid out by
    ``head_positions`` (``positions`` overrides it). A pad head then adds
    nothing, whatever it attends to. ``experts``: the padded expert count
    of the moe family (``padded_experts(ep_degree)``); the extra experts'
    weights are zero, and no token routes to them. Works on any device and
    dtype; the other leaves are the same tensors."""
    import dataclasses

    if dataclasses.replace(padded_cfg, num_heads=cfg.num_heads) != cfg:
        raise ValueError("the padded config differs from the config in more than its heads")
    hd = cfg.head_dim
    heads = positions or head_positions(cfg.num_heads, padded_cfg.num_heads,
                                        cfg.num_kv_heads)

    def cols(like: torch.Tensor) -> torch.Tensor:
        idx = torch.tensor(heads, device=like.device)[:, None] * hd + torch.arange(
            hd, device=like.device)
        return idx.reshape(-1)

    def widen(w: torch.Tensor, dim: int, size: int, idx) -> torch.Tensor:
        shape = list(w.shape)
        shape[dim] = size
        out = w.new_zeros(shape)
        out.index_copy_(dim, idx, w)
        return out

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: walk(v) for k, v in tree.items()}
        if {"wq", "wk", "wv", "wo"} <= set(tree):
            idx = cols(tree["wq"])
            out["wq"] = widen(tree["wq"], tree["wq"].ndim - 1, padded_cfg.num_heads * hd, idx)
            out["wo"] = widen(tree["wo"], tree["wo"].ndim - 2, padded_cfg.num_heads * hd, idx)
        if experts is not None and {"router", "gate", "up", "down"} <= set(tree):
            for name in ("gate", "up", "down"):
                w = tree[name]
                dim = w.ndim - 3
                out[name] = widen(w, dim, experts, torch.arange(w.shape[dim], device=w.device))
        return out

    return walk(params)
