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
