"""Mixture-of-Experts layer with top-k routing and capacity-based dispatch,
ported from ``repro/models/moe.py`` (the granite configs).

GShard-style grouped capacity dispatch as dense dispatch and combine
products, as in the reference: tokens are cut into groups, each group
routes its tokens on its own with a per-group expert capacity, and the
(token, choice) pairs past an expert's capacity are dropped (their gate is
zeroed; the token falls through to the residual). The router runs in f32;
dispatch, the experts and combine in the activation dtype.

Experts padded beyond ``num_experts`` (granite-3b: 40 -> 48 on a 16-way
expert-parallel axis) get -inf router logits, so no token routes to them,
and their weights stay zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import Params, _init


def moe_init(gen: torch.Generator, d: int, d_ff: int, num_experts: int,
             num_experts_padded: int | None = None, *, stack: int = 0,
             dtype: torch.dtype = torch.float32) -> Params:
    """The router ``[d, E]`` in f32 (``layers.F32_LEAVES``) at 1/sqrt(d);
    the experts' ``gate``/``up`` ``[E_pad, d, d_ff]`` and ``down``
    ``[E_pad, d_ff, d]`` in ``dtype`` at the reference's default scale,
    1/sqrt(shape[0]) = 1/sqrt(E_pad) (not the fan-in), the padded experts
    zeroed. ``stack > 0`` adds a leading layer axis."""
    e_pad = num_experts_padded or num_experts
    kw = dict(stack=stack, dtype=dtype)
    p = {
        "router": _init(gen, (d, num_experts), stack=stack),
        "gate": _init(gen, (e_pad, d, d_ff), **kw),
        "up": _init(gen, (e_pad, d, d_ff), **kw),
        "down": _init(gen, (e_pad, d_ff, d), **kw),
    }
    for name in ("gate", "up", "down"):
        p[name].narrow(1 if stack else 0, num_experts, e_pad - num_experts).zero_()
    return p


def group_size_of(B: int, S: int, group_size: int = 1024) -> int:
    """Tokens a routing group: ``min(group_size, B*S)``; if that does not
    divide B*S, one sequence (S) when S divides it, else all B*S."""
    T = B * S
    sg = min(group_size, T)
    if T % sg:
        sg = S if T % S == 0 else T
    return sg


def capacity_of(sg: int, num_experts: int, experts_per_token: int,
                capacity_factor: float) -> int:
    """Slots an expert has in a group of ``sg`` tokens (real experts, not
    padded ones), in Python floats as the reference computes it."""
    C = max(1, int(capacity_factor * sg * experts_per_token / max(num_experts, 1)))
    return min(C, sg)


def moe_ffn(p: Params, x: torch.Tensor, *, num_experts: int, experts_per_token: int,
            capacity_factor: float = 1.25, group_size: int = 1024,
            routes: list | None = None, group: int | None = None,
            experts: tuple[int, int] | None = None, aux_sums: bool = False):
    """x [B, S, d] -> (output [B, S, d] in x's dtype, f32 aux load-balancing
    loss). With ``routes`` (a list), appends this call's routing
    ``(expert_idx, slot)``, each [G, S_g, k]: the chosen experts in order,
    and each choice's place in its expert's queue (C where it was dropped).

    Expert parallelism (a rank of a sharding policy's "model" axis):
    ``experts`` = (first, E_pad) says that ``p``'s gate/up/down hold the
    experts first .. first + E_local - 1 of E_pad; the output is then this
    rank's part of a sum over the ranks, its experts' share. ``group``
    fixes the tokens a routing group (default ``group_size_of(B, S,
    group_size)``), for a rank that holds whole groups of a larger batch.
    ``aux_sums``: return, in place of the aux loss, the sums it is made of
    over this call's tokens (router probabilities [E] and top-k choices [E]
    of the real experts, and the token count), for a caller that adds them
    over ranks first.

    Routing: f32 logits (-inf for padded experts), softmax, the top k with
    ties to the lower index (as ``lax.top_k``), gates renormalised over
    the k; a (token, choice) pair's place in its expert's queue is counted
    in (token, then choice) order, and pairs at or past the capacity C are
    dropped. The three-operand combine is contracted in pairs, so no
    [G, S_g, k, E, C] tensor is built."""
    B, S, d = x.shape
    first, E_pad = experts or (0, p["gate"].shape[0])
    E_loc = p["gate"].shape[0]
    k = experts_per_token
    sg = group or group_size_of(B, S, group_size)
    G = B * S // sg
    xt = x.reshape(G, sg, d)

    # the three ranges name the parts of a traced step (launch.trace.by_range)
    with record_function("moe.dispatch"):
        logits = xt.float() @ p["router"].float()
        if E_pad > num_experts:
            logits = torch.cat([logits, logits.new_full((G, sg, E_pad - num_experts),
                                                        float("-inf"))], dim=-1)
        probs = torch.softmax(logits, dim=-1)  # [G, S_g, E_pad]
        # a stable descending sort keeps equal probabilities in index order
        expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
        gate_vals = probs.gather(-1, expert_idx)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        C = capacity_of(sg, num_experts, k, capacity_factor)
        onehot = F.one_hot(expert_idx, E_pad)  # [G, S_g, k, E_pad]
        # each expert's queue counted along a contiguous last axis: a scan
        # over the middle axis of [G, S_g k, E_pad] took 80 ms of a traced
        # granite-moe-1b-a400m training step (48 calls; NVIDIA H100 80GB
        # HBM3, 700.00 W)
        flat = onehot.reshape(G, sg * k, E_pad).transpose(1, 2).contiguous()
        before = (flat.cumsum(-1) - flat).transpose(1, 2).reshape(G, sg, k, E_pad)
        pos = before.gather(-1, expert_idx[..., None])[..., 0]  # [G, S_g, k]
        keep = pos < C
        gate_vals = gate_vals * keep
        slot = torch.where(keep, pos, C)
        if routes is not None:
            routes.append((expert_idx, slot))

        # dispatch / combine [G, S_g, E_pad, C]; a dropped pair's slot C is cut off
        cap = F.one_hot(slot, C + 1)[..., :C].to(x.dtype)
        oh = (onehot if experts is None else onehot[..., first:first + E_loc]).to(x.dtype)
        dispatch = torch.einsum("gske,gskc->gsec", oh, cap)
        combine = torch.einsum("gske,gskc->gsec", oh * gate_vals.to(x.dtype)[..., None], cap)
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xt)

    with record_function("moe.experts"):
        g_ = torch.einsum("egcd,edf->egcf", expert_in, p["gate"].to(x.dtype))
        u = torch.einsum("egcd,edf->egcf", expert_in, p["up"].to(x.dtype))
        expert_out = torch.einsum("egcf,efd->egcd", F.silu(g_) * u, p["down"].to(x.dtype))

    with record_function("moe.combine"):
        out = torch.einsum("gsec,egcd->gsd", combine, expert_out)
        # Switch-style aux loss over the real experts: the fraction of top-k
        # choices (before the capacity drop) times the mean router probability
        if aux_sums:
            return out.reshape(B, S, d), (probs[..., :num_experts].sum((0, 1)),
                                          onehot[..., :num_experts].sum(2).float().sum((0, 1)),
                                          G * sg)
        me = probs[..., :num_experts].mean((0, 1))
        ce = onehot[..., :num_experts].sum(2).float().mean((0, 1))
        aux = num_experts * (me * ce).sum()
    return out.reshape(B, S, d), aux


def aux_from_sums(num_experts: int, prob_sum, choice_sum, tokens: int) -> torch.Tensor:
    """The aux loss of ``moe_ffn`` from its ``aux_sums`` added over ranks."""
    return num_experts * ((prob_sum / tokens) * (choice_sum / tokens)).sum()
