"""Carry parameters from the JAX package into the port, through numpy.

The port never sees jax: a caller converts the reference's param pytree to
numpy first (``jax.tree.map(np.asarray, params)``) and hands it over.
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
