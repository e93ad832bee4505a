"""The LM of every family of ``repro/models/transformer.py``, ported for
serving and training: dense (GQA + SwiGLU: llama3.2-1b, chatglm3-6b,
internlm2-20b, h2o-danube-3-4b), moe (GQA + a top-k MoE FFN:
granite-moe-1b-a400m, granite-moe-3b-a800m), ssm (a Mamba2/SSD stack,
mamba2-370m), hybrid (Mamba2 blocks with one shared attention block after
every ``hybrid_attn_period`` of them, zamba2-7b), encdec (a bidirectional
encoder over stub audio frames and a causal decoder with cross-attention,
whisper-medium) and vlm (the dense decoder over stub image patches ahead of
the tokens, llava-next-34b):

  * init(seed)                                -> params (stacked [L, ...])
  * loss(params, batch)                       -> (scalar loss, metrics)
  * forward_logits(params, tokens, frames=, patches=)
                                              -> [B, S, vocab] f32
  * prefill(params, tokens, frames=, patches=, max_seq=...)
                                              -> (last logits [B, vocab], cache)
  * decode_init(batch, max_seq)               -> KV (+ cross) and/or SSM cache
  * decode_step(params, cache, tokens, pos)   -> (logits [B, vocab], cache)

``frames`` [B, T, d] (encdec) and ``patches`` [B, P, d] (vlm) are the
frontend stubs' embeddings, as the reference's batch keys of those names.
The layer stack is a Python loop over the stacked parameters (the
reference's ``lax.scan``). Prefill attention (self and cross) goes through
the flash-attention kernel and the prefill SSD scan through the SSD kernel;
the loss's attention through the forward and backward flash kernels and
its SSD scan through the forward and backward SSD kernels; decode and the
MoE layer's dense dispatch are plain torch, as in the reference.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    MetaDraws,
    Params,
    embed,
    embedding_init,
    layer,
    linear_init,
    rms_norm,
    rms_norm_init,
    softmax_xent,
    softmax_xent_sums,
    swiglu,
    swiglu_init,
    unembed,
    unembed_separate,
    unstack,
)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


class LM:
    def __init__(self, cfg: ModelConfig, *, ep_degree: int = 1, device=None,
                 attention=kops.flash_attention,
                 attention_bwd=kops.flash_attention_bwd,
                 ssd_scan=kops.ssd_scan, ssd_scan_bwd=kops.ssd_scan_bwd,
                 remat: bool = False, policy=None):
        """``device``: 'cuda' (the default; raises without a card) or 'cpu'.
        ``attention``, ``attention_bwd``, ``ssd_scan`` and ``ssd_scan_bwd``:
        the attention forward and backward and the SSD scan and its
        backward; the kernels unless a comparison swaps in the plain
        versions. ``remat``: the loss recomputes each block's activations
        (Mamba or attention) in the backward (``torch.utils.checkpoint``),
        as the reference's ``remat``. ``ep_degree``: the moe family's
        experts are padded to a multiple of it (``cfg.padded_experts``), as
        in the reference; 1 on one card. ``routes``: set it to a list and
        each MoE layer appends its routing to it (``moe.moe_ffn``).

        ``policy`` (``launch.sharding.ShardingPolicy`` of this config, on a
        mesh of the process group's size): ``init`` places the params on
        its mesh, and ``loss``, ``forward_logits``, ``prefill`` and
        ``decode_step`` run on DTensors, tensor-parallel on "model"
        (Megatron: attention heads, SwiGLU columns, experts and the
        vocabulary split; the residual stream sharded on sequence between
        blocks), data-parallel on "pod" and "data" with the weights
        gathered from their FSDP shards a use. Logits and caches come back
        as DTensors; the loss is a plain scalar, the same on every rank.
        Every family but ssm takes any "model" size that divides the
        attention heads (``pad_heads``); the ssm family any "model" size.
        Mamba2 blocks split their SSD heads over "model" where they divide
        it (else every rank runs every head), the encdec encoder runs
        Megatron as the decoder does, and the cross cache splits on
        sequence as ``kv_cache_spec`` says."""
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; known: {', '.join(FAMILIES)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.attention = attention
        self.attention_bwd = attention_bwd
        self.ssd_scan = ssd_scan
        self.ssd_scan_bwd = ssd_scan_bwd
        self.remat = remat
        self.e_pad = cfg.padded_experts(ep_degree) if cfg.is_moe else 0
        self.routes: list | None = None
        self.policy = policy
        if policy is not None:
            self._check_policy()

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, seed: int = 0, param_dtype: torch.dtype | None = None) -> Params:
        """Seeded random params with the reference's distributions and dict
        paths (not its bits: torch and jax.random differ). Weights are stored
        in ``param_dtype`` (f32 master weights for training), by default in
        the config dtype, each cast as soon as it is drawn; the leaves of
        ``layers.F32_LEAVES`` are f32 either way. Every use casts a weight
        to the compute dtype, as the reference does. Under a policy the
        params are placed on its mesh (``param_shardings``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self._init_tree(gen, param_dtype or self.dtype)
        return params if self.policy is None else self.policy.param_shardings(params)

    def param_stand_ins(self, param_dtype: torch.dtype | None = None) -> Params:
        """``init``'s tree (unplaced) as meta tensors of its leaves' shapes
        and dtypes, made by the same code with nothing drawn
        (``layers.MetaDraws``): no memory, no process group."""
        return self._init_tree(MetaDraws(), param_dtype or self.dtype)

    def _init_tree(self, gen, wd: torch.dtype) -> Params:
        """The param tree drawn from ``gen`` (a generator, or ``MetaDraws``)
        on its device, weights in ``wd``."""
        c, dev = self.cfg, gen.device
        extra: Params = {}
        if c.family == "ssm":
            layers = self._mamba_init(gen, c.num_layers, wd)
        elif c.family == "hybrid":
            groups, rem = divmod(c.num_layers, c.hybrid_attn_period)
            layers = self._mamba_init(gen, groups * c.hybrid_attn_period, wd)
            if rem:
                extra["tail_layers"] = self._mamba_init(gen, rem, wd)
            extra["shared_attn"] = self._block_init(gen, 0, wd)
        elif c.family == "encdec":
            extra["enc_layers"] = self._block_init(gen, c.encoder_layers, wd)
            extra["enc_ln"] = rms_norm_init(c.d_model, dev)
            layers = self._decoder_init(gen, c.num_layers, wd)
        else:
            layers = self._block_init(gen, c.num_layers, wd)
        params: Params = {
            "embed": embedding_init(gen, c.vocab_size, c.d_model, dtype=wd),
            "final_ln": rms_norm_init(c.d_model, dev),
            "layers": layers,
            **extra,
        }
        if not c.tie_embeddings:
            params["unembed"] = linear_init(gen, c.d_model, c.vocab_size, dtype=wd)
        return params

    def _block_init(self, gen: torch.Generator, n: int, dtype: torch.dtype) -> Params:
        """``n`` stacked attention + FFN blocks (one unstacked if 0): SwiGLU
        ``mlp``, or ``moe`` in the moe family."""
        c, dev = self.cfg, gen.device
        p = {
            "ln1": rms_norm_init(c.d_model, dev, stack=n),
            "attn": attn.attention_init(gen, c.d_model, c.num_heads, c.num_kv_heads,
                                        c.head_dim, stack=n, dtype=dtype),
            "ln2": rms_norm_init(c.d_model, dev, stack=n),
        }
        if c.is_moe:
            p["moe"] = moe_mod.moe_init(gen, c.d_model, c.moe_d_ff, c.num_experts,
                                        self.e_pad, stack=n, dtype=dtype)
        else:
            p["mlp"] = swiglu_init(gen, c.d_model, c.d_ff, stack=n, dtype=dtype)
        return p

    def _decoder_init(self, gen: torch.Generator, n: int, dtype: torch.dtype) -> Params:
        """``n`` stacked decoder blocks of the encdec family: self-attention,
        cross-attention (``xattn``, normed by ``ln_x``) and SwiGLU."""
        c, dev = self.cfg, gen.device

        def attention():
            return attn.attention_init(gen, c.d_model, c.num_heads, c.num_kv_heads,
                                       c.head_dim, stack=n, dtype=dtype)

        return {
            "ln1": rms_norm_init(c.d_model, dev, stack=n),
            "attn": attention(),
            "ln_x": rms_norm_init(c.d_model, dev, stack=n),
            "xattn": attention(),
            "ln2": rms_norm_init(c.d_model, dev, stack=n),
            "mlp": swiglu_init(gen, c.d_model, c.d_ff, stack=n, dtype=dtype),
        }

    def _mamba_init(self, gen: torch.Generator, n: int, dtype: torch.dtype) -> Params:
        """``n`` stacked Mamba2 blocks."""
        c = self.cfg
        return {
            "ln": rms_norm_init(c.d_model, gen.device, stack=n),
            "ssd": ssm_mod.ssd_init(gen, c.d_model, expand=c.ssm_expand,
                                    head_dim=c.ssm_head_dim, state=c.ssm_state,
                                    conv_width=c.ssm_conv_width, stack=n, dtype=dtype),
        }

    # ------------------------------------------------------------------
    # loss (train)
    # ------------------------------------------------------------------
    def _ffn(self, lp: Params, h: torch.Tensor):
        """The block's FFN with its residual on ``h`` (after attention):
        (h + FFN(norm(h)), the MoE layer's aux loss or None for SwiGLU)."""
        c = self.cfg
        x = rms_norm(lp["ln2"], h, c.norm_eps)
        if "moe" not in lp:
            return h + swiglu(lp["mlp"], x), None
        y, aux = moe_mod.moe_ffn(lp["moe"], x, num_experts=c.num_experts,
                                 experts_per_token=c.experts_per_token,
                                 capacity_factor=c.capacity_factor, routes=self.routes)
        return h + y, aux

    def _block_train(self, lp: Params, h: torch.Tensor, causal: bool = True):
        """An attention + FFN block for the loss: (h, aux or None); the
        encoder's blocks run with ``causal`` False."""
        c = self.cfg
        h = h + attn.attention_train(
            lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps), causal=causal,
            attention=self.attention, attention_bwd=self.attention_bwd,
            **self._attn_kwargs())
        return self._ffn(lp, h)

    def _decoder_train(self, lp: Params, h: torch.Tensor, enc: torch.Tensor):
        """An encdec decoder block for the loss, over the encoder output
        ``enc``: (h, None)."""
        c = self.cfg
        h = h + attn.attention_train(
            lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps),
            attention=self.attention, attention_bwd=self.attention_bwd,
            **self._attn_kwargs())
        h = h + attn.cross_attention(
            lp["xattn"], rms_norm(lp["ln_x"], h, c.norm_eps), self._cross_kv(lp, enc),
            num_heads=c.num_heads, head_dim=c.head_dim, attention=self.attention,
            attention_bwd=self.attention_bwd)
        return self._ffn(lp, h)

    def _cross_kv(self, lp: Params, enc: torch.Tensor):
        c = self.cfg
        return attn.encode_cross_kv(lp["xattn"], enc, num_kv_heads=c.num_kv_heads,
                                    head_dim=c.head_dim)

    def _mamba(self, lp: Params, h: torch.Tensor,
               cache: Params | None = None) -> torch.Tensor:
        """One Mamba2 block with its residual, for the loss and prefill."""
        c = self.cfg
        return h + ssm_mod.ssd_block(
            lp["ssd"], rms_norm(lp["ln"], h, c.norm_eps),
            head_dim=c.ssm_head_dim, state=c.ssm_state, chunk=c.ssm_chunk,
            conv_width=c.ssm_conv_width, scan=self.ssd_scan,
            scan_bwd=self.ssd_scan_bwd, cache=cache)

    def _run(self, block, *args):
        """``block(*args)``, its activations recomputed in the backward
        under ``remat``."""
        return checkpoint(block, *args, use_reentrant=False) if self.remat else block(*args)

    def loss(self, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: tokens [B,S], labels [B,S] (labels < 0 are masked), and
        ``frames`` [B,T,d] (encdec) or ``patches`` [B,P,d] (vlm). The mean
        token cross-entropy through the training attention and SSD scan
        plus 0.01 x ``moe_aux``, the MoE layers' aux losses summed over the
        stack (0 in the other families), and the reference's metrics. The
        blocks run in ``_stack``'s order; the hybrid's shared block runs
        under autograd at each call, so its gradients sum over the calls.
        The vlm's logits are taken at the token positions only: the
        reference takes them over the whole (padded) sequence and masks the
        patch and pad labels, which leaves the same mean."""
        if self.policy is not None:
            return self._loss_tp(params, batch)
        h, enc = self._inputs(params, batch["tokens"], batch.get("frames"),
                              batch.get("patches"), train=True)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, lp, _ in self._stack(params, None):
            h, a = self._train_block(kind, lp, h, enc)
            if a is not None:
                aux = aux + a
        h = h[:, h.shape[1] - batch["tokens"].shape[1]:]  # the vlm's token positions
        xent = softmax_xent(self._logits(params, h), batch["labels"])
        return xent + 0.01 * aux, {"xent": xent, "moe_aux": aux}

    def _train_block(self, kind: str, lp: Params, h: torch.Tensor, enc):
        """One block of ``_stack`` for the loss: (h, the MoE aux or None)."""
        if kind == "ssm":
            return self._run(self._mamba, lp, h), None
        return (self._run(self._decoder_train, lp, h, enc) if kind == "dec"
                else self._run(self._block_train, lp, h))

    def _inputs(self, params: Params, tokens: torch.Tensor, frames, patches, *,
                train: bool = False):
        """(the decoder's input [B, L, d], the encoder output or None): the
        token embeddings; in the vlm family behind the patches, at positions
        0..P-1 (L = P + S); in the encdec family with the frames encoded.
        The reference right-pads the vlm's P + S positions to a multiple of
        512 (``_pad_seq``) to keep its blockwise attention tiled; the flash
        kernels take any length, and under the causal mask a padded tail
        reaches no real position, so nothing is padded here."""
        c = self.cfg
        self._inputs_given(frames, patches)
        h = embed(params["embed"], tokens, self.dtype)
        if c.family == "vlm":
            h = torch.cat([patches.to(self.dtype), h], dim=1)
        if c.family != "encdec":
            return h, None
        return h, self._encode(params, frames.to(self.dtype), train)

    def _inputs_given(self, frames, patches) -> None:
        """Raise unless the family's stub input, and only it, is given."""
        c = self.cfg
        given = {"frames": frames is not None, "patches": patches is not None}
        wanted = {"frames": c.family == "encdec", "patches": c.family == "vlm"}
        if given != wanted:
            raise ValueError(f"the {c.family} family takes "
                             f"{[k for k, w in wanted.items() if w] or 'no stub inputs'}; "
                             f"got {[k for k, g in given.items() if g]}")

    def _encode(self, params: Params, frames: torch.Tensor, train: bool) -> torch.Tensor:
        """The encdec encoder over the stub frames [B,T,d]: bidirectional
        attention + SwiGLU blocks with RoPE at 0..T-1, then ``enc_ln``."""
        c = self.cfg
        h = frames
        for lp in unstack(params["enc_layers"]):
            if train:
                h, _ = self._run(self._block_train, lp, h, False)
            else:
                a, _, _ = attn.attention_prefill(
                    lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps), causal=False,
                    attention=self.attention, **self._attn_kwargs())
                h, _ = self._ffn(lp, h + a)
        return rms_norm(params["enc_ln"], h, c.norm_eps)

    # ------------------------------------------------------------------
    # forward / prefill
    # ------------------------------------------------------------------
    def _attn_kwargs(self) -> dict:
        c = self.cfg
        return dict(num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
                    head_dim=c.head_dim, rope_theta=c.rope_theta,
                    rotary_pct=c.rotary_pct, window=c.sliding_window,
                    softcap=c.attn_logit_softcap)

    def _stack(self, params: Params, cache: Params | None):
        """(kind, layer params, its cache slice or None) for each block in
        the order the stack runs them; kind is "attn" (attention + SwiGLU or
        MoE FFN), "dec" (an encdec decoder block, whose slice is {"kv",
        "cross"}) or "ssm" (a Mamba2 block). The hybrid family runs each
        group of ``hybrid_attn_period`` Mamba blocks, then the shared
        attention block on the group's own KV cache slot, and the tail
        blocks last. The
        stacked trees are taken apart by ``unstack``, so the loss's gradient
        of each is one stacked tensor."""
        c = self.cfg
        layers = self._unstack(params["layers"])

        def sub(key, i):
            return None if cache is None else layer(cache[key], i)

        if c.family in ("dense", "moe", "vlm"):
            for i in range(c.num_layers):
                yield "attn", layers[i], sub("kv", i)
            return
        if c.family == "encdec":
            for i in range(c.num_layers):
                yield "dec", layers[i], (None if cache is None else
                                         {"kv": sub("kv", i), "cross": sub("cross", i)})
            return
        if c.family == "ssm":
            for i in range(c.num_layers):
                yield "ssm", layers[i], sub("ssm", i)
            return
        period = c.hybrid_attn_period
        groups = c.num_layers // period
        for g in range(groups):
            for i in range(g * period, (g + 1) * period):
                yield "ssm", layers[i], sub("ssm", i)
            yield "attn", params["shared_attn"], sub("kv", g)
        tail = self._unstack(params["tail_layers"]) if "tail_layers" in params else []
        for i, lp in enumerate(tail):
            yield "ssm", lp, sub("ssm_tail", i)

    def _body(self, params: Params, h: torch.Tensor, cache: Params | None = None,
              enc: torch.Tensor | None = None) -> torch.Tensor:
        """The layer stack at positions 0..L-1, over the encoder output
        ``enc`` in the encdec family. With ``cache`` (from ``decode_init``),
        each attention block's rotated k and v, each decoder block's cross
        k and v of ``enc``, and each Mamba block's SSM state and conv
        windows are written into it."""
        for kind, lp, sl in self._stack(params, cache):
            h = self._prefill_block(kind, lp, h, sl, enc)
        return h

    def _prefill_block(self, kind: str, lp: Params, h: torch.Tensor, sl, enc) -> torch.Tensor:
        """One block of ``_stack`` at positions 0..L-1, filling its cache
        slice ``sl`` if given."""
        c = self.cfg
        if kind == "ssm":
            return self._mamba(lp, h, sl)
        a, k, v = attn.attention_prefill(
            lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps),
            attention=self.attention, **self._attn_kwargs())
        kv_slice = sl["kv"] if kind == "dec" and sl is not None else sl
        if kv_slice is not None:
            self._fill_cache(kv_slice, k, v, h.shape[1])
        h = h + a
        if kind == "dec":
            ck, cv = self._cross_kv(lp, enc)
            if sl is not None:
                sl["cross"]["k"].copy_(ck)
                sl["cross"]["v"].copy_(cv)
            h = h + attn.cross_attention(
                lp["xattn"], rms_norm(lp["ln_x"], h, c.norm_eps), (ck, cv),
                num_heads=c.num_heads, head_dim=c.head_dim, attention=self.attention)
        return self._ffn(lp, h)[0]

    def _fill_cache(self, kv_slice: Params, k, v, S: int, T: int | None = None,
                    t0: int = 0) -> None:
        """Write the rotated k/v of positions 0..S-1 into a cache of T slots
        (a ring of the last T under a sliding window), of which
        ``kv_slice`` holds slots t0 .. t0 + its length - 1 (a policy's
        cache split on sequence; all T by default)."""
        n = kv_slice["k"].shape[1]
        T = T or n
        if self.cfg.sliding_window > 0:  # ring buffer: the last T positions
            pos = torch.arange(max(0, S - T), S, device=k.device)
            slots = pos % T
        else:
            if S > T:
                raise ValueError(f"prompt of {S} tokens exceeds cache of {T}")
            pos = slots = torch.arange(S, device=k.device)
        if n != T:  # this rank's slots only
            mine = (slots >= t0) & (slots < t0 + n)
            pos, slots = pos[mine], slots[mine] - t0
        kv_slice["k"][:, slots] = k[:, pos].to(kv_slice["k"].dtype)
        kv_slice["v"][:, slots] = v[:, pos].to(kv_slice["v"].dtype)

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = rms_norm(params["final_ln"], h, c.norm_eps)
        return (unembed(params["embed"], h) if c.tie_embeddings
                else unembed_separate(params["unembed"], h))

    def forward_logits(self, params: Params, tokens: torch.Tensor, *,
                       frames: torch.Tensor | None = None,
                       patches: torch.Tensor | None = None) -> torch.Tensor:
        """Inference prefill: tokens [B,S] (with the family's stub input)
        -> the tokens' f32 logits [B,S,vocab] (a DTensor under a policy)."""
        if self.policy is not None:
            return self._forward_logits_tp(params, tokens, frames, patches)
        h, enc = self._inputs(params, tokens, frames, patches)
        h = self._body(params, h, None, enc)
        return self._logits(params, h[:, h.shape[1] - tokens.shape[1]:])

    def prefill(self, params: Params, tokens: torch.Tensor, *,
                frames: torch.Tensor | None = None, patches: torch.Tensor | None = None,
                max_seq: int | None = None, cache_dtype=None):
        """One pass over the prompt: returns (f32 logits of the last position
        [B, vocab], a cache of ``max_seq`` positions (default L, the
        prompt's P + S in the vlm family, S otherwise) holding every
        attention block's rotated k/v at 0..L-1, every decoder block's
        cross k/v of the encoded ``frames`` and every Mamba block's f32
        state after S tokens and conv windows). Decode goes on at position
        L. In the dense, ssm, hybrid and encdec families it equals stepping
        ``decode_step`` over the prompt from a cache that holds the cross
        k/v (the reference's ``decode_init`` leaves them zero, and nothing
        of the reference fills them). In the moe family it does only where
        no (token, choice) pair is dropped: the MoE layer routes the prompt
        in groups of up to 1024 tokens with a capacity a group, and a
        decode step routes its B tokens as one group, whose capacity at the
        configs' factor is ~1 slot an expert."""
        c = self.cfg
        if frames is not None and frames.shape[1] != c.encoder_seq:
            raise ValueError(f"{frames.shape[1]} frames; the cross cache holds "
                             f"encoder_seq = {c.encoder_seq}")
        if self.policy is not None:
            return self._prefill_tp(params, tokens, frames, patches, max_seq, cache_dtype)
        h, enc = self._inputs(params, tokens, frames, patches)
        cache = self.decode_init(tokens.shape[0], max_seq or h.shape[1],
                                 dtype=cache_dtype or self.dtype)
        h = self._body(params, h, cache, enc)
        return self._logits(params, h[:, -1:])[:, 0], cache

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def decode_init(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16) -> Params:
        """The reference's cache layout: ``kv`` [blocks, B, T, KV, hd] in
        ``dtype`` for the attention blocks (the hybrid family's shared block
        has one slot a group), T = min(max_seq, window) under a sliding
        window; the encdec decoder's ``cross`` k/v [L, B, encoder_seq, KV,
        hd] in ``dtype``, zero until a prefill fills them; ``ssm`` (and the
        hybrid tail's ``ssm_tail``) f32 state and conv windows whatever
        ``dtype`` is. Under a policy, each leaf a DTensor placed by
        ``cache_shardings``."""
        cache = self._cache(batch_size, max_seq, dtype)
        if self.policy is None:
            return cache
        from torch.distributed.tensor import distribute_tensor

        pol = self.policy
        specs = pol.cache_shardings(cache, batch_size)
        # each rank keeps its own shard of the zeros: nothing is sent
        return _map_with_path(lambda path, leaf: distribute_tensor(
            leaf, pol.device_mesh, pol.placements(_at(specs, path)), src_data_rank=None),
            cache)

    def cache_stand_ins(self, batch_size: int, max_seq: int,
                        dtype=torch.bfloat16) -> Params:
        """``decode_init``'s tree (unplaced) as meta tensors: no memory."""
        return self._cache(batch_size, max_seq, dtype, torch.device("meta"))

    def _cache(self, batch_size: int, max_seq: int, dtype, device=None) -> Params:
        c = self.cfg
        device = device or self.device

        def ssm(n):
            return ssm_mod.init_ssm_cache(
                batch_size, c.d_inner, c.ssm_head_dim, c.ssm_state,
                c.ssm_conv_width, device=device, stack=n)

        def kv(n, kv_len=None):
            kv_len = kv_len or (min(max_seq, c.sliding_window) if c.sliding_window > 0
                                else max_seq)
            shape = (n, batch_size, kv_len, c.num_kv_heads, c.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}

        if c.family == "ssm":
            return {"ssm": ssm(c.num_layers)}
        if c.family in ("dense", "moe", "vlm"):
            return {"kv": kv(c.num_layers)}
        if c.family == "encdec":
            return {"kv": kv(c.num_layers), "cross": kv(c.num_layers, c.encoder_seq)}
        groups, rem = divmod(c.num_layers, c.hybrid_attn_period)
        cache = {"ssm": ssm(groups * c.hybrid_attn_period), "kv": kv(groups)}
        if rem:
            cache["ssm_tail"] = ssm(rem)
        return cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: int):
        """tokens: [B] int; pos: absolute position. Returns (logits [B, vocab]
        f32, cache); the cache is updated in place and returned. Under a
        policy the logits are a DTensor split as ``logits_spec``, and
        ``tokens`` may be a DTensor too (their argmax)."""
        if self.policy is not None:
            return self._decode_step_tp(params, cache, tokens, pos)
        x = embed(params["embed"], tokens[:, None], self.dtype)  # [B,1,d]
        for kind, lp, sl in self._stack(params, cache):
            x = self._decode_block(kind, lp, x, sl, pos)
        return self._logits(params, x)[:, 0, :], cache

    def _decode_block(self, kind: str, lp: Params, x: torch.Tensor, sl, pos: int):
        """One block of ``_stack`` for the token at ``pos``, writing its
        cache slice ``sl`` in place."""
        c = self.cfg
        if kind == "ssm":
            return x + ssm_mod.ssd_decode_step(
                lp["ssd"], rms_norm(lp["ln"], x, c.norm_eps), sl,
                head_dim=c.ssm_head_dim, state=c.ssm_state)
        kv_slice = sl["kv"] if kind == "dec" else sl
        x = x + attn.attention_decode(
            lp["attn"], rms_norm(lp["ln1"], x, c.norm_eps), kv_slice, pos,
            **self._attn_kwargs())
        if kind == "dec":
            x = x + attn.cross_attention(
                lp["xattn"], rms_norm(lp["ln_x"], x, c.norm_eps),
                (sl["cross"]["k"], sl["cross"]["v"]), num_heads=c.num_heads,
                head_dim=c.head_dim)
        return self._ffn(lp, x)[0]

    # ------------------------------------------------------------------
    # under a sharding policy
    # ------------------------------------------------------------------
    # The residual stream h is a DTensor between blocks, [B, L, d] split as
    # ``_hspec``: batch on the data-parallel axes, sequence on "model"
    # (the reference's ``seq_spec``) where they divide it. Inside a block
    # each rank computes on local tensors: the kernels take plain CUDA
    # tensors, a rank's own heads. The local weights come from
    # ``ShardingPolicy.weight``, whose gradient is this rank's part of a
    # sum over the axes on which ranks hold other tokens, heads or experts
    # (``split``), and the whole of it where ranks repeat one computation.

    def _check_policy(self) -> None:
        c, pol = self.cfg, self.policy
        if pol.cfg != c:
            raise ValueError("the policy was made for another config")
        if pol.tp is None:
            raise ValueError(f"the mesh {pol.all_axes} has no 'model' axis")
        if pol.mesh.device_type != self.device.type:
            raise ValueError(f"a {pol.mesh.device_type} mesh for a model on {self.device}")
        tp = pol.tp_size
        # the ssm family has no attention heads (pad_heads leaves it alone)
        if c.family != "ssm" and c.num_heads % tp:
            raise ValueError(f"{c.num_heads} heads on model = {tp}: pad them first "
                             f"(launch.sharding.pad_heads)")
        if self.e_pad % tp:
            raise ValueError(f"{self.e_pad} experts on model = {tp}: pass ep_degree={tp}")

    def _unstack(self, tree: Params) -> list[Params]:
        """``unstack``; under the policy, of DTensors: each leaf's local
        shard is taken apart and each layer made a DTensor again (DTensor's
        own view ops refuse to run in inference mode)."""
        return unstack(tree, None if self.policy is None else _unbind_dtensor)

    def _local(self, tree: Params, split=(), whole: bool = False) -> Params:
        """Every weight of a param subtree as this rank's local tensor; with
        ``whole`` gathered over "model" too (every "model" rank repeats the
        computation, so each takes its gradient whole)."""
        if isinstance(tree, dict):
            return {k: self._local(v, split, whole) for k, v in tree.items()}
        if whole:
            return self.policy.to_local(tree, (None,) * tree.ndim, split)
        return self.policy.weight(tree, split)

    def _hspec(self, B: int, L: int) -> tuple:
        """The residual stream's spec: the reference's ``seq_spec`` less the
        axes that do not divide B or L (the reference leaves those to
        GSPMD)."""
        pol = self.policy
        return (pol.dp if B % pol.dp_size == 0 else None,
                pol.tp if pol.tp_size > 1 and L % pol.tp_size == 0 else None, None)

    def _constrain_seq(self, h):
        """h in the residual stream's spec (the reference's constraint at
        the same points of the stack)."""
        if self.policy is None:
            return h
        return self.policy.constrain(h, self._hspec(*h.shape[:2]))

    def _size(self, entry) -> int:
        sizes = self.policy.mesh.axis_sizes
        return math.prod(sizes[a] for a in _axes((entry,)))

    def _index(self, entry) -> int:
        """This rank's place among the ranks that split a dimension by
        ``entry`` (major to minor)."""
        pol, i = self.policy, 0
        for a in _axes((entry,)):
            i = i * pol.mesh.axis_sizes[a] + pol.coordinate(a)
        return i

    def _part(self, entry, n: int) -> slice:
        """This rank's part of a dimension of ``n`` split by ``entry``."""
        m = n // self._size(entry)
        return slice(self._index(entry) * m, (self._index(entry) + 1) * m)

    def _gather(self, t: torch.Tensor, bdim, dim: int, split=()) -> torch.Tensor:
        """This rank's rows of ``t`` (split on batch by ``bdim``) split on
        ``dim`` over "model" -> the whole of ``dim`` (every head: dim 2 of
        [B, S, heads, hd]), its gradient as ``to_local`` takes it."""
        pol = self.policy
        spec = [bdim, *(None,) * (t.ndim - 1)]
        whole = tuple(spec)
        spec[dim] = pol.tp
        return pol.to_local(pol.from_local(t, tuple(spec)), whole, split)

    def _embed_tp(self, table, tokens: torch.Tensor, bdim) -> torch.Tensor:
        """Token embeddings of this rank's rows [B_loc, S, d], the same on
        every "model" rank. A table split on vocabulary is looked up where
        each rank holds the token's row and summed over "model"."""
        pol = self.policy
        tok = tokens[self._part(bdim, tokens.shape[0])]
        bs = (bdim, None, None)
        if pol.spec_of(table)[0] != pol.tp:
            return embed({"table": pol.weight(table, _axes(bs))}, tok, self.dtype)
        w = pol.weight(table, (*_axes(bs), pol.tp))  # [V_loc, d]
        v0 = pol.coordinate(pol.tp) * w.shape[0]
        mine = ((tok >= v0) & (tok < v0 + w.shape[0]))[..., None].to(self.dtype)
        e = embed({"table": w}, (tok - v0).clamp(0, w.shape[0] - 1), self.dtype) * mine
        return pol.to_local(pol.from_local(e, bs, partial=(pol.tp,)), bs)

    def _inputs_tp(self, params: Params, tokens, frames, patches, train: bool = False):
        """(h, a DTensor in ``_hspec``; this rank's rows of the encoder
        output or None): ``_inputs`` under the policy."""
        c, pol = self.cfg, self.policy
        self._inputs_given(frames, patches)
        B, S = tokens.shape
        L = S + (patches.shape[1] if patches is not None else 0)
        hs = self._hspec(B, L)
        rows = self._part(hs[0], B)
        h = self._embed_tp(params["embed"]["table"], tokens, hs[0])
        if c.family == "vlm":
            h = torch.cat([patches[rows].to(self.dtype), h], dim=1)
        enc = None
        if c.family == "encdec":
            enc = self._encode_tp(params, frames[rows].to(self.dtype), B, hs[0], train)
        return pol.constrain(pol.from_local(h, (hs[0], None, None)), hs), enc

    def _encode_tp(self, params: Params, frames: torch.Tensor, B: int, bdim, train: bool):
        """The encoder over this rank's rows of the frames [B_loc, T, d]:
        the encoder output of those rows over every frame, a plain tensor.
        At model = 1 the plain encoder; else Megatron blocks (attention
        non-causal) on a residual stream split on sequence where T divides
        "model", the output gathered over "model" with its gradient this
        rank's part of a sum (each rank reads it for its own heads)."""
        c, pol = self.cfg, self.policy
        if pol.tp_size == 1:
            local = self._local({k: params[k] for k in ("enc_layers", "enc_ln")},
                                _axes((bdim,)))
            return self._encode(local, frames, train)
        es = self._hspec(B, frames.shape[1])
        h = pol.constrain(pol.from_local(frames, (bdim, None, None)), es)
        for lp in self._unstack(params["enc_layers"]):
            h, _ = self._run(self._block_tp, "enc", lp, h, None, None, train)
        x = rms_norm(self._local(params["enc_ln"], _axes(es)), h.to_local(), c.norm_eps)
        return pol.to_local(pol.from_local(x, es), (bdim, None, None), split=(pol.tp,))

    def _heads(self, w: Params) -> tuple:
        """(this rank's query heads, the first of them, the KV heads of its
        wk columns (KV / model where wk is split, else all), the ones among
        those that its query heads read or None for all)."""
        c, pol = self.cfg, self.policy
        H = c.num_heads // pol.tp_size
        first = pol.coordinate(pol.tp) * H
        kv_w = w["wk"].shape[-1] // c.head_dim
        sel = None
        if kv_w == c.num_kv_heads:  # wk replicated: the KV heads these heads read
            sel = attn.local_kv_heads(c.num_heads, c.num_kv_heads, first, H)
            if sel == slice(0, kv_w):
                sel = None
        return H, first, kv_w, sel

    def _attn_tp(self, p: Params, x_loc: torch.Tensor, hs: tuple, train: bool,
                 causal: bool = True):
        """Megatron attention: ``x_loc`` (normed, in ``hs``) gathered over
        "model"; this rank's heads through the flash kernel(s); their wo
        rows' products summed over "model" into ``hs``. Returns (out, the
        rotated k and v of this rank's rows, [B_loc, L, KV_w, hd], KV_w the
        KV heads of its wk columns)."""
        pol = self.policy
        bs = (hs[0], None, None)
        x = pol.to_local(pol.from_local(x_loc, hs), bs, split=(pol.tp,))
        w = self._local(p, (*_axes(bs), pol.tp))
        H, _, kv_w, sel = self._heads(w)
        kw = {**self._attn_kwargs(), "num_heads": H, "num_kv_heads": kv_w}
        out, k, v = attn.self_attention(
            w, x, causal=causal, attention=self.attention,
            attention_bwd=self.attention_bwd if train else None, kv_heads=sel, **kw)
        return pol.constrain(pol.from_local(out, bs, partial=(pol.tp,)), hs), k, v

    def _cross_tp(self, p: Params, x_loc: torch.Tensor, hs: tuple, enc: torch.Tensor,
                  cross: Params | None, train: bool):
        """Megatron cross-attention: ``x_loc`` (normed, in ``hs``) gathered
        over "model"; this rank's heads over every frame of ``enc`` (this
        rank's rows) through the flash kernel(s), non-causal; their wo
        rows' products summed over "model" into ``hs``. With ``cross`` (this
        rank's shard of the layer's cross cache), every KV head's k/v at
        its slots are written there."""
        c, pol = self.cfg, self.policy
        bs = (hs[0], None, None)
        x = pol.to_local(pol.from_local(x_loc, hs), bs, split=(pol.tp,))
        w = self._local(p, (*_axes(bs), pol.tp))
        H, _, kv_w, sel = self._heads(w)
        k, v = attn.encode_cross_kv(w, enc, num_kv_heads=kv_w, head_dim=c.head_dim)
        if cross is not None:
            kc, vc = k, v
            if kv_w < c.num_kv_heads:
                kc, vc = self._gather(k, hs[0], 2), self._gather(v, hs[0], 2)
            t0, _ = self._kv_split(x.shape[0] * self._size(hs[0]), c.encoder_seq)
            n = cross["k"].shape[1]
            cross["k"].copy_(kc[:, t0:t0 + n])
            cross["v"].copy_(vc[:, t0:t0 + n])
        if sel is not None:
            k, v = k[:, :, sel], v[:, :, sel]
        out = attn.cross_attention(w, x, (k, v), num_heads=H, head_dim=c.head_dim,
                                   attention=self.attention,
                                   attention_bwd=self.attention_bwd if train else None)
        return pol.constrain(pol.from_local(out, bs, partial=(pol.tp,)), hs)

    def _mean_sq(self, bdim, width: int):
        """The gated norm's mean of squares at model > 1 (``ssm.ssd_block``'s
        ``mean_sq``): this rank's channels' sum of squares, gathered over
        "model" and added in rank order (every rank holds the same bits),
        over the whole d_inner ``width``. Each rank's gradient of the total
        goes back to every rank's part."""
        pol = self.policy

        def mean_sq(yf: torch.Tensor) -> torch.Tensor:
            parts = self._gather(yf.square().sum(-1, keepdim=True), bdim, -1,
                                 split=(pol.tp,))
            return parts.sum(-1, keepdim=True) / width
        return mean_sq

    def _whole_conv_x(self, sl: Params | None, bdim, gather: bool):
        """The SSM cache shard ``sl`` with a conv_x window of every channel
        for a rank that runs every head (``_mamba_tp``): the shard itself
        where conv_x is replicated, else a copy whose conv_x is gathered
        (decode) or zero (prefill), to be written back by ``_own_conv_x``."""
        if sl is None or sl["conv_x"].shape[-1] == self.cfg.d_inner:
            return sl
        win = sl["conv_x"]
        whole = (self._gather(win, bdim, -1) if gather else
                 win.new_zeros(*win.shape[:-1], self.cfg.d_inner))
        return {**sl, "conv_x": whole}

    def _own_conv_x(self, sl: Params | None, whole: Params | None) -> None:
        if whole is not sl:
            part = self._part(self.policy.tp, self.cfg.d_inner)
            sl["conv_x"].copy_(whole["conv_x"][..., part])

    def _mamba_tp(self, p: Params, x_loc: torch.Tensor, hs: tuple, sl: Params | None):
        """A Mamba2 block at model > 1 over ``x_loc`` (normed, in ``hs``),
        into ``hs``; ``sl`` this rank's shard of its SSM cache, or None.
        The scan needs the whole sequence: x is gathered over "model" on
        this rank's rows. Where the SSD heads divide "model", this rank's
        heads (its w_z, w_x, w_dt, conv_x columns, per-head leaves and
        out_proj rows; w_B, w_C, conv_B and conv_C replicated, their
        gradient a sum over "model") go through the scan kernel, the gated
        norm's squares are summed over "model" and the out_proj products
        too. Else (e.g. 6 heads on 4 ranks, whose d_inner leaves split but
        whose per-head leaves do not) every rank runs the whole block with
        the weights gathered, the same on every rank, and takes each
        gradient whole."""
        c, pol = self.cfg, self.policy
        bs = (hs[0], None, None)
        kw = dict(head_dim=c.ssm_head_dim, state=c.ssm_state, chunk=c.ssm_chunk,
                  conv_width=c.ssm_conv_width, scan=self.ssd_scan, scan_bwd=self.ssd_scan_bwd)
        if c.ssm_heads % pol.tp_size == 0:
            x = pol.to_local(pol.from_local(x_loc, hs), bs, split=(pol.tp,))
            w = self._local(p, (*_axes(bs), pol.tp))
            y = ssm_mod.ssd_block(w, x, cache=sl, mean_sq=self._mean_sq(hs[0], c.d_inner), **kw)
            return pol.constrain(pol.from_local(y, bs, partial=(pol.tp,)), hs)
        x = pol.to_local(pol.from_local(x_loc, hs), bs)
        whole = self._whole_conv_x(sl, hs[0], gather=False)
        y = ssm_mod.ssd_block(self._local(p, _axes(bs), whole=True), x, cache=whole, **kw)
        self._own_conv_x(sl, whole)
        return pol.constrain(pol.from_local(y, bs), hs)

    def _mlp_tp(self, p: Params, x_loc: torch.Tensor, xs: tuple):
        """SwiGLU of ``x_loc`` (in ``xs``) into ``xs``: column- then
        row-parallel over "model" where gate/up split on d_ff, else on this
        rank's tokens alone."""
        pol = self.policy
        if pol.spec_of(p["gate"])[-1] != pol.tp:
            return pol.from_local(swiglu(self._local(p, _axes(xs)), x_loc), xs)
        bs = (xs[0], None, None)
        x = pol.to_local(pol.from_local(x_loc, xs), bs, split=(pol.tp,))
        y = swiglu(self._local(p, (*_axes(bs), pol.tp)), x)
        return pol.constrain(pol.from_local(y, bs, partial=(pol.tp,)), xs)

    def _moe_tp(self, p: Params, x_loc: torch.Tensor, xs: tuple):
        """The MoE layer of ``x_loc`` (in ``xs``) into ``xs``, with its aux
        loss (the same on every rank). Experts split over "model"; each
        rank routes every token of the routing groups it holds (its rows
        where the groups fall within them, else every row) and runs its
        own experts; their outputs sum over "model". The aux loss is made
        of the router sums over all ranks' tokens."""
        c, pol = self.cfg, self.policy
        Bl, Sl, _ = x_loc.shape
        B, S = Bl * self._size(xs[0]), Sl * self._size(xs[1])
        sg = moe_mod.group_size_of(B, S)
        rdim = xs[0] if (Bl * S) % sg == 0 else None  # whole groups a rank
        rs = (rdim, None, None)
        x = pol.to_local(pol.from_local(x_loc, xs), rs, split=(pol.tp,))
        tp = pol.tp_size
        plain = tp == 1 and self._size(rdim) == 1
        w = self._local(p, (*_axes(rs), pol.tp))
        y, aux = moe_mod.moe_ffn(
            w, x, num_experts=c.num_experts, experts_per_token=c.experts_per_token,
            capacity_factor=c.capacity_factor, routes=self.routes, group=sg,
            experts=None if tp == 1 else (pol.coordinate(pol.tp) * w["gate"].shape[0],
                                          self.e_pad),
            aux_sums=not plain)
        y = pol.constrain(pol.from_local(y, rs, partial=(pol.tp,)), xs)
        if not plain:
            prob, choice, n = aux
            sums = pol.to_local(pol.from_local(torch.stack([prob, choice]), (None, None),
                                               partial=_axes(rs)), (None, None))
            aux = moe_mod.aux_from_sums(c.num_experts, sums[0], sums[1], n * self._size(rdim))
            # every "model" rank holds the same aux: each adds 1/tp of it, so
            # that its gradient reaches the router once
            aux = pol.to_local(pol.from_local((aux / tp)[None], (None,),
                                              partial=(pol.tp,)), (None,))[0]
        return y, aux

    def _ffn_tp(self, lp: Params, h, hs: tuple):
        """(h + FFN(norm(h)), the MoE aux or None) under the policy."""
        c = self.cfg
        x = rms_norm(self._local(lp["ln2"], _axes(hs)), h.to_local(), c.norm_eps)
        if "moe" in lp:
            y, aux = self._moe_tp(lp["moe"], x, hs)
            return h + y, aux
        return h + self._mlp_tp(lp["mlp"], x, hs), None

    def _kv_split(self, B: int, T: int) -> tuple[int, object]:
        """(this rank's first cache slot, the sequence entry of
        ``kv_cache_spec``) of a KV cache of T slots."""
        entry = self.policy.kv_cache_spec(B, T)[2]
        return self._index(entry) * (T // self._size(entry)), entry

    def _dec_whole(self, sl, T: int) -> bool:
        """Whether a decoder block's cache slice (this rank's shard) holds
        every slot of its self and cross caches (or there is none)."""
        return sl is None or (sl["kv"]["k"].shape[1] == T
                              and sl["cross"]["k"].shape[1] == self.cfg.encoder_seq)

    def _block_tp(self, kind: str, lp: Params, h, sl, enc, train: bool,
                  t0: int = 0, T: int = 0):
        """One block of ``_stack`` under the policy (or "enc", an encoder
        block: attention non-causal, no cache), h a DTensor; ``sl`` this
        rank's shard (self-attention slots t0 .. of T) of its cache slice,
        or None; ``enc`` this rank's rows of the encoder output over every
        frame. Returns (h, the MoE aux or None). At model = 1 a Mamba block,
        and a decoder block whose caches are whole, run as without a policy
        on this rank's rows."""
        c, pol = self.cfg, self.policy
        hs = self._hspec(*h.shape[:2])
        if pol.tp_size == 1 and (kind == "ssm" or kind == "dec" and self._dec_whole(sl, T)):
            lp, h_loc = self._local(lp, _axes(hs)), h.to_local()
            if train:
                h_loc, aux = self._train_block(kind, lp, h_loc, enc)
            else:
                h_loc, aux = self._prefill_block(kind, lp, h_loc, sl, enc), None
            return pol.from_local(h_loc, hs), aux
        if kind == "ssm":
            x = rms_norm(self._local(lp["ln"], _axes(hs)), h.to_local(), c.norm_eps)
            return h + self._mamba_tp(lp["ssd"], x, hs, sl), None
        x = rms_norm(self._local(lp["ln1"], _axes(hs)), h.to_local(), c.norm_eps)
        a, k, v = self._attn_tp(lp["attn"], x, hs, train, causal=kind != "enc")
        kv = sl["kv"] if kind == "dec" and sl is not None else sl
        if kv is not None:
            if k.shape[2] < c.num_kv_heads:
                k, v = self._gather(k, hs[0], 2), self._gather(v, hs[0], 2)
            self._fill_cache(kv, k, v, h.shape[1], T, t0)
        h = h + a
        if kind == "dec":
            x = rms_norm(self._local(lp["ln_x"], _axes(hs)), h.to_local(), c.norm_eps)
            h = h + self._cross_tp(lp["xattn"], x, hs, enc,
                                   None if sl is None else sl["cross"], train)
        return self._ffn_tp(lp, h, hs)

    def _body_tp(self, params: Params, h, cache: Params | None, enc, train: bool):
        """``_body`` / the loss's stack under the policy (``cache``: a
        DTensor cache to fill, or None): (h, aux sum)."""
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        t0 = T = 0
        if cache is not None and "kv" in cache:
            T = cache["kv"]["k"].shape[2]
            t0, _ = self._kv_split(h.shape[0], T)
        h = self._constrain_seq(h)
        local = None if cache is None else _local_views(cache)
        for kind, lp, sl in self._stack(params, local):
            h, a = self._run(self._block_tp, kind, lp, h, sl, enc, train, t0, T)
            if a is not None:
                aux = aux + a
            h = self._constrain_seq(h)
        return h, aux

    def _logits_tp(self, params: Params, h_loc: torch.Tensor, split=(),
                   vocab: bool = False) -> torch.Tensor:
        """f32 logits of this rank's positions ``h_loc`` [.., d]: over the
        whole vocabulary (the reference's constraint on [B, S, V] logits,
        sequence split), or with ``vocab`` this rank's part of it where
        the unembedding splits it (``logits_spec``)."""
        c, pol = self.cfg, self.policy
        h = rms_norm(self._local(params["final_ln"], split), h_loc, c.norm_eps)
        w = self._unembedding(params)
        local = (pol.weight(w, split) if vocab else
                 pol.to_local(w, (None, None), split))
        return (unembed({"table": local}, h) if c.tie_embeddings
                else unembed_separate({"w": local}, h))

    def _unembedding(self, params: Params):
        """The unembedding weight: the tied table [V, d] or ``unembed.w`` [d, V]."""
        return params["embed"]["table"] if self.cfg.tie_embeddings else params["unembed"]["w"]

    def _loss_tp(self, params: Params, batch: dict):
        """``loss`` under the policy: the token cross-entropy summed on each
        rank's positions, then over the ranks."""
        c, pol = self.cfg, self.policy
        tokens, labels = batch["tokens"], batch["labels"]
        h, enc = self._inputs_tp(params, tokens, batch.get("frames"), batch.get("patches"),
                                 train=True)
        h, aux = self._body_tp(params, h, None, enc, train=True)
        B, L = h.shape[:2]
        hs = self._hspec(B, L)
        if L != tokens.shape[1]:  # the vlm: patch positions carry no label
            labels = torch.cat([labels.new_full((B, L - tokens.shape[1]), -1), labels], 1)
        labels = labels[self._part(hs[0], B)][:, self._part(hs[1], L)]
        logits = self._logits_tp(params, h.to_local(), _axes(hs))
        nll, count = softmax_xent_sums(logits, labels)
        sums = pol.to_local(pol.from_local(torch.stack([nll, count]), (None,),
                                           partial=_axes(hs)), (None,))
        xent = sums[0] / sums[1].clamp_min(1.0)
        return xent + 0.01 * aux, {"xent": xent, "moe_aux": aux}

    def _forward_logits_tp(self, params: Params, tokens, frames, patches):
        pol = self.policy
        h, enc = self._inputs_tp(params, tokens, frames, patches)
        h, _ = self._body_tp(params, h, None, enc, train=False)
        hs = self._hspec(*h.shape[:2])
        logits = pol.from_local(self._logits_tp(params, h.to_local(), _axes(hs)),
                                (hs[0], hs[1], None))
        return logits[:, h.shape[1] - tokens.shape[1]:]

    def _prefill_tp(self, params: Params, tokens, frames, patches, max_seq, cache_dtype):
        c, pol = self.cfg, self.policy
        if frames is not None and frames.shape[1] != c.encoder_seq:
            raise ValueError(f"{frames.shape[1]} frames; the cross cache holds "
                             f"encoder_seq = {c.encoder_seq}")
        h, enc = self._inputs_tp(params, tokens, frames, patches)
        B, L = h.shape[:2]
        cache = self.decode_init(B, max_seq or L, dtype=cache_dtype or self.dtype)
        h, _ = self._body_tp(params, h, cache, enc, train=False)
        hs = self._hspec(B, L)
        last = pol.to_local(h, (hs[0], None, None))[:, -1:]
        return self._last_logits(params, last, hs[0]), cache

    def _last_logits(self, params: Params, x_loc: torch.Tensor, bdim):
        """[B, V] logits of this rank's rows of one position, split as
        ``logits_spec``."""
        pol = self.policy
        vdim = -2 if self.cfg.tie_embeddings else -1  # the vocabulary's dim of w
        vocab = pol.spec_of(self._unembedding(params))[vdim] == pol.tp
        logits = self._logits_tp(params, x_loc, vocab=True)[:, 0]
        return pol.from_local(logits, (bdim, pol.tp if vocab else None))

    def _attn_decode_tp(self, p: Params, x: torch.Tensor, sl: Params, pos: int,
                        bdim, t0: int, T: int, seq) -> torch.Tensor:
        """One token's attention on this rank's rows ``x`` [B_loc, 1, d]
        (the same on every "model" rank) and its shard ``sl`` of the cache,
        slots t0 .. t0 + len - 1 of T: the token's k/v written where its
        slot lies; this rank's heads (``_decode_attend``), summed over
        "model"."""
        c, pol = self.cfg, self.policy
        w = self._local(p)
        H = c.num_heads // pol.tp_size
        first = pol.coordinate(pol.tp) * H
        kv_w = w["wk"].shape[-1] // c.head_dim
        kw = self._attn_kwargs()
        q, k, v = attn._qkv(w, x, torch.full((1,), pos, device=x.device), num_heads=H,
                            num_kv_heads=kv_w, head_dim=c.head_dim,
                            rope_theta=kw["rope_theta"], rotary_pct=kw["rotary_pct"])
        if kv_w < c.num_kv_heads:
            k, v = self._gather(k, bdim, 2), self._gather(v, bdim, 2)
        window = c.sliding_window
        slot = pos % T if window > 0 else pos
        n = sl["k"].shape[1]
        if t0 <= slot < t0 + n:  # this rank's shard holds the slot: write there
            sl["k"][:, slot - t0] = k[:, 0].to(sl["k"].dtype)
            sl["v"][:, slot - t0] = v[:, 0].to(sl["v"].dtype)
        kpos = t0 + torch.arange(n, device=x.device)
        valid = ((kpos <= pos % T) | (pos >= T)) if window > 0 else kpos <= pos
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = torch.where(valid, zero, float("-inf"))[None, :]
        out = self._decode_attend(q, sl, mask, bdim, first, seq, kw["softcap"])
        return self._decode_out(out.to(x.dtype), w, bdim)

    def _decode_attend(self, q: torch.Tensor, sl: Params, mask: torch.Tensor, bdim,
                       first: int, seq, softcap: float) -> torch.Tensor:
        """Decode attention of this rank's query heads ``q`` [B_loc, 1, H_loc,
        hd] (heads first ..) over its shard ``sl`` of a cache of every KV
        head, ``mask`` [1, its slots]. Where the cache splits on sequence
        (``seq``, its axes), each rank takes every head over its own slots
        and the parts combine by their softmax statistics (flash decoding)."""
        c, pol = self.cfg, self.policy
        H = q.shape[2]
        if self._size(seq) == 1:
            sel = attn.local_kv_heads(c.num_heads, c.num_kv_heads, first, H)
            return attn.attend(q, sl["k"][:, :, sel], sl["v"][:, :, sel], mask,
                               softcap=softcap)
        if pol.tp_size > 1:
            q = self._gather(q, bdim, 2)
        o, m, lsum = attn.attention_scores_partial(q, sl["k"], sl["v"], mask, softcap=softcap)
        mx = m.clone()
        dm = pol.device_mesh
        import torch.distributed as dist
        for a in _axes((seq,)):
            dist.all_reduce(mx, dist.ReduceOp.MAX, group=dm.get_group(a))
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        scale = torch.where(torch.isinf(m), zero, torch.exp(m - mx))
        o, lsum = o * scale[..., None], lsum * scale
        for a in _axes((seq,)):
            dist.all_reduce(o, group=dm.get_group(a))
            dist.all_reduce(lsum, group=dm.get_group(a))
        return (o / lsum[..., None])[:, :, first:first + H]

    def _decode_out(self, out: torch.Tensor, w: Params, bdim) -> torch.Tensor:
        """This rank's heads' attention output [B_loc, 1, H_loc, hd] through
        its wo rows, summed over "model"."""
        pol = self.policy
        a = out.reshape(*out.shape[:2], -1) @ w["wo"].to(out.dtype)
        bs = (bdim, None, None)
        return pol.to_local(pol.from_local(a, bs, partial=(pol.tp,)), bs)

    def _cross_decode_tp(self, p: Params, x: torch.Tensor, cross: Params, bdim, seq):
        """One token's cross-attention on this rank's rows ``x`` [B_loc, 1,
        d] over its shard ``cross`` of the layer's cross cache (split on
        sequence over ``seq``): this rank's heads, no mask, summed over
        "model"."""
        c, pol = self.cfg, self.policy
        w = self._local(p)
        H = c.num_heads // pol.tp_size
        q = attn._split_heads(x @ w["wq"].to(x.dtype), H, c.head_dim)
        mask = torch.zeros((1, cross["k"].shape[1]), dtype=torch.float32, device=x.device)
        out = self._decode_attend(q, cross, mask, bdim, pol.coordinate(pol.tp) * H, seq, 0.0)
        return self._decode_out(out.to(x.dtype), w, bdim)

    def _mamba_decode_tp(self, p: Params, x: torch.Tensor, sl: Params, bdim):
        """One token's Mamba2 block at model > 1 on this rank's rows ``x``
        [B_loc, 1, d] (the same on every "model" rank) and its shard ``sl``
        of the SSM cache, written in place: as ``_mamba_tp``, this rank's
        heads summed over "model", or every head on every rank."""
        c, pol = self.cfg, self.policy
        kw = dict(head_dim=c.ssm_head_dim, state=c.ssm_state)
        if c.ssm_heads % pol.tp_size == 0:
            y = ssm_mod.ssd_decode_step(self._local(p), x, sl,
                                        mean_sq=self._mean_sq(bdim, c.d_inner), **kw)
            bs = (bdim, None, None)
            return pol.to_local(pol.from_local(y, bs, partial=(pol.tp,)), bs)
        whole = self._whole_conv_x(sl, bdim, gather=True)
        y = ssm_mod.ssd_decode_step(self._local(p, whole=True), x, whole, **kw)
        self._own_conv_x(sl, whole)
        return y

    def _decode_step_tp(self, params: Params, cache: Params, tokens: torch.Tensor, pos: int):
        c, pol = self.cfg, self.policy
        if hasattr(tokens, "full_tensor"):  # the argmax of the last logits
            tokens = tokens.full_tensor()
        B = tokens.shape[0]
        bdim = pol.dp if B % pol.dp_size == 0 else None
        bs = (bdim, None, None)
        T = cache["kv"]["k"].shape[2] if "kv" in cache else 0
        t0, seq = self._kv_split(B, T) if T else (0, None)
        seq_x = self._kv_split(B, c.encoder_seq)[1] if "cross" in cache else None
        split = pol.tp_size > 1 or self._size(seq) > 1 or self._size(seq_x) > 1
        x = self._embed_tp(params["embed"]["table"], tokens[:, None], bdim)  # [B_loc,1,d]
        for kind, lp, sl in self._stack(params, _local_views(cache)):
            if kind == "ssm" and pol.tp_size > 1:
                x = x + self._mamba_decode_tp(
                    lp["ssd"], rms_norm(self._local(lp["ln"]), x, c.norm_eps), sl, bdim)
            elif kind != "ssm" and split:
                kv = sl["kv"] if kind == "dec" else sl
                x = x + self._attn_decode_tp(
                    lp["attn"], rms_norm(self._local(lp["ln1"]), x, c.norm_eps), kv, pos,
                    bdim, t0, T, seq)
                if kind == "dec":
                    x = x + self._cross_decode_tp(
                        lp["xattn"], rms_norm(self._local(lp["ln_x"]), x, c.norm_eps),
                        sl["cross"], bdim, seq_x)
                x = self._ffn_tp(lp, pol.from_local(x, bs), bs)[0].to_local()
            else:  # model = 1 and whole caches: the plain block on own rows
                x = self._decode_block(kind, self._local(lp), x, sl, pos)
        return self._last_logits(params, x, bdim), cache


def _axes(spec) -> tuple:
    """The mesh axes named in a spec, in its order."""
    out = []
    for e in spec:
        out.extend(e if isinstance(e, tuple) else (() if e is None else (e,)))
    return tuple(out)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _local_views(cache: Params) -> Params:
    """Each rank's shard of a DTensor cache, as plain tensors that share its
    storage: writes into them are writes into the cache."""
    return _map_with_path(lambda _, leaf: leaf.to_local(), cache)


def _unbind_dtensor(t) -> list:
    """The layers of a stacked DTensor, each a DTensor over its local shard."""
    from torch.distributed.tensor import DTensor, Shard

    placements = [Shard(p.dim - 1) if p.is_shard() else p for p in t.placements]
    return [DTensor.from_local(x, t.device_mesh, placements, run_check=False)
            for x in t.to_local().unbind(0)]
