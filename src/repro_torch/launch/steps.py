"""Step builders, ported from ``repro/launch/steps.py``: the train, prefill
and decode step of one (arch x shape x mesh) cell as a :class:`StepBundle`,
with a stand-in for every argument and the spec of every input and output.

Stand-ins are meta-device tensors with the paths, shapes and dtypes of what
the step takes (the reference's ``ShapeDtypeStruct``s): the params as
``LM.init(param_dtype=torch.float32)`` gives them, the AdamW moments, the
batch and the decode cache. They come from the same code that draws the
real ones (``LM.param_stand_ins``, ``LM.cache_stand_ins``), allocate
nothing and need no process group. The shardings are the port's spec tuples
(``launch.sharding``; ``ShardingPolicy.placements`` turns a spec into
DTensor placements), read from the mesh's names and sizes alone, so every
cell of a production mesh is built anywhere.

Token ids (``tokens``, ``labels`` and the decode step's ``tokens`` and
``pos``) are int64, the port's token dtype (``data.pipeline.DataPipeline``
yields it); the reference's are int32. The AdamW step counter's stand-in is
the reference's 0-d int32; the port's state holds the counter as a Python
int.

The step takes its batch (and the decode step its tokens) as whole tensors
on every rank, as the launchers feed them, or placed by ``in_shardings``
as DTensors, as the reference's jitted step takes them (the dry run,
``launch/dryrun.py``): a placed input is gathered whole first, since
``LM(policy=)`` picks each rank's rows itself.

The bundle's ``fn`` runs eagerly. The reference's ``jitted()`` and
``lower()`` (ahead-of-time lowering through XLA) have no torch counterpart.
Running ``fn`` needs the params on the policy's mesh (``lm.init`` or
``lm.policy.param_shardings``), and that needs a process group of the
mesh's size. ``adamw_update`` updates the params and the AdamW state in
place: ``donate_argnums`` records it, and a caller that wants its inputs
again clones them first.

One difference from the reference, on purpose: the train step's ``xent`` is
the mean cross-entropy at every accum. The reference's at accum > 1 is its
total loss, aux term included (``metrics = {"xent": loss, ...}``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.bridge import named_leaves
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import P, ShardingPolicy, pad_heads
from repro_torch.models import LM
from repro_torch.models.layers import Params
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule

TOKEN_DTYPE = torch.int64


def _meta(dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def f32(*shape):
    return _meta(torch.float32, shape)


def bf16(*shape):
    return _meta(torch.bfloat16, shape)


def i32(*shape):
    return _meta(torch.int32, shape)


def tok(*shape):
    """A stand-in of token ids (or a position) in ``TOKEN_DTYPE``."""
    return _meta(TOKEN_DTYPE, shape)


@dataclass
class StepBundle:
    """Everything needed to run one (arch x shape x mesh) cell."""

    arch: str
    shape: ShapeSpec
    cfg: ModelConfig  # padded config actually built
    lm: LM
    fn: Callable
    args: tuple  # meta-device stand-ins
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def whole(x):
    """A DTensor input gathered whole on every rank; a plain one as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for every model input of a step."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": tok(B, S), "labels": tok(B, S)}
        if cfg.family == "encdec":
            batch["frames"] = bf16(B, cfg.encoder_seq, cfg.d_model)
        if cfg.family == "vlm":
            batch["patches"] = bf16(B, cfg.num_patches, cfg.d_model)
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"tokens": tok(B), "pos": tok()}


def batch_shardings(policy: ShardingPolicy, cfg: ModelConfig,
                    shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": policy.batch_spec(B, S), "labels": policy.batch_spec(B, S)}
    if cfg.family == "encdec":
        s = policy.tp if cfg.encoder_seq % max(policy.tp_size, 1) == 0 else None
        out["frames"] = P(policy.dp if B % policy.dp_size == 0 else None, s, None)
    if cfg.family == "vlm":
        s = policy.tp if cfg.num_patches % max(policy.tp_size, 1) == 0 else None
        out["patches"] = P(policy.dp if B % policy.dp_size == 0 else None, s, None)
    if shape.kind == "prefill":
        out.pop("labels")
    return out


# Gradient-accumulation (microbatch) steps per arch for train_4k, the
# reference's: a step runs its global batch as this many microbatches one
# after another, which divides the activation memory a step holds by the
# factor. llava-next-34b's 8 makes its microbatch 32 sequences, the
# multi-pod mesh's data-parallel degree (2 x 16), the least that keeps
# every data rank busy.
ACCUM_STEPS: dict[str, int] = {
    "llava-next-34b": 8,
    "internlm2-20b": 4,
    "zamba2-7b": 2,
}


def compute_cast(params: Params) -> Params:
    """The bf16 compute copies of the f32 masters, the reference's rule:
    every f32 leaf of ndim >= 2 (the stacked norm scales, the router and
    the SSM's ``A_log`` / ``dt_bias`` / ``D`` included) in bf16, the
    others as they are. Each leaf is a fresh autograd leaf, so the
    gradients are taken at the copies (bf16 where the copy is)."""
    def cast(p):
        p = p.detach()
        if p.dtype == torch.float32 and p.ndim >= 2:
            p = p.to(torch.bfloat16)
        return p.requires_grad_(True)

    return _map(cast, params)


def mean_of_sum(gsum: Params, n: int) -> Params:
    """The microbatches' f32 gradient sum divided by their count, in place."""
    for _, g in named_leaves(gsum):
        g.div_(n)
    return gsum


def build_bundle(arch: str, shape: str | ShapeSpec, mesh, *,
                 collective_backend: str = "xla",
                 accum_steps: int | None = None) -> StepBundle:
    """The step of one cell: ``shape`` names an entry of ``SHAPES``, or is
    a ``ShapeSpec`` of its own (one card holds no train_4k step at one
    rank). ``mesh`` is a ``launch.mesh.Mesh``; the model runs on its
    device type. ``collective_backend`` is the reference's keyword, which
    its body reads nowhere either. ``accum_steps`` overrides
    ``ACCUM_STEPS`` (default 1)."""
    base_cfg = get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    policy = ShardingPolicy(mesh, base_cfg)
    cfg = pad_heads(base_cfg, policy.tp_size)
    policy.cfg = cfg
    lm = LM(cfg, ep_degree=policy.tp_size, device=mesh.device_type, policy=policy,
            remat=(shape.kind == "train"))

    params_s = lm.param_stand_ins(torch.float32)
    p_shard = policy.param_specs(params_s)

    if shape.kind == "train":
        opt_s = adamw_init(params_s)
        opt_s.step = i32()
        o_shard = _opt_shardings(policy, params_s, opt_s)
        batch_s = input_specs(cfg, shape)
        b_shard = batch_shardings(policy, cfg, shape)
        lr = cosine_schedule(3e-4, warmup=100, total=10000)
        accum = accum_steps if accum_steps is not None else ACCUM_STEPS.get(arch, 1)
        if accum < 1 or shape.global_batch % accum:
            raise ValueError(f"accum {accum} does not divide the batch of "
                             f"{shape.global_batch}")

        def grad_fn(params, batch):
            """(loss, metrics, grads) at the bf16 compute copies."""
            pc = compute_cast(params)
            loss, metrics = lm.loss(pc, batch)
            loss.backward()
            grads = _map(lambda t: t.grad, pc)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

        def train_step(params, opt_state, batch):
            batch = {k: whole(v) for k, v in batch.items()}
            if accum > 1:
                # microbatches on the batch dim; the f32 gradient sum keeps
                # the sum exact and the activations are a microbatch's
                parts = {k: v.chunk(accum) for k, v in batch.items()}
                micro = [{k: p[i] for k, p in parts.items()} for i in range(accum)]
                gsum, lsum, xsum, asum = None, 0.0, 0.0, 0.0
                for mb in micro:
                    loss, metrics, grads = grad_fn(params, mb)
                    if gsum is None:
                        gsum = _map(lambda g: g.float(), grads)
                    else:
                        for (_, a), (_, g) in zip(named_leaves(gsum), named_leaves(grads)):
                            a.add_(g)
                    del grads
                    lsum, xsum = lsum + loss, xsum + metrics["xent"]
                    asum = asum + metrics["moe_aux"]
                grads = mean_of_sum(gsum, accum)
                loss = lsum / accum
                metrics = {"xent": xsum / accum, "moe_aux": asum / accum}
            else:
                loss, metrics, grads = grad_fn(params, batch)
            new_params, new_opt, om = adamw_update(params, grads, opt_state, lr=lr)
            return new_params, new_opt, {"loss": loss, **metrics, **om}

        scalar = P()
        out_shardings = (
            p_shard, o_shard,
            {"loss": scalar, "xent": scalar, "moe_aux": scalar,
             "grad_norm": scalar, "lr": scalar},
        )
        return StepBundle(arch, shape, cfg, lm, train_step,
                          (params_s, opt_s, batch_s),
                          (p_shard, o_shard, b_shard), out_shardings,
                          donate_argnums=(0, 1))

    if shape.kind == "prefill":
        batch_s = input_specs(cfg, shape)
        b_shard = batch_shardings(policy, cfg, shape)

        @torch.no_grad()
        def prefill_step(params, batch):
            batch = {k: whole(v) for k, v in batch.items()}
            return lm.forward_logits(params, batch["tokens"], frames=batch.get("frames"),
                                     patches=batch.get("patches"))

        out_shardings = P(
            policy.dp if shape.global_batch % policy.dp_size == 0 else None,
            policy.tp if shape.seq_len % max(policy.tp_size, 1) == 0 else None,
            None)
        return StepBundle(arch, shape, cfg, lm, prefill_step,
                          (params_s, batch_s), (p_shard, b_shard),
                          out_shardings)

    # decode
    cache_s = lm.cache_stand_ins(shape.global_batch, shape.seq_len)
    c_shard = policy.cache_shardings(cache_s, shape.global_batch)
    tok_shard = policy.token_spec(shape.global_batch)
    pos_shard = P()

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return lm.decode_step(params, cache, whole(tokens), int(pos))

    out_shardings = (policy.logits_spec(shape.global_batch), c_shard)
    return StepBundle(
        arch, shape, cfg, lm, serve_step,
        (params_s, cache_s, tok(shape.global_batch), tok()),
        (p_shard, c_shard, tok_shard, pos_shard), out_shardings,
        donate_argnums=(1,))


def _opt_shardings(policy: ShardingPolicy, params_s, opt_s) -> AdamWState:
    """AdamW moments shard exactly like their parameters (ZeRO); the step
    counter is replicated."""
    p_shard = policy.param_specs(params_s)
    return type(opt_s)(P(), p_shard, p_shard)
