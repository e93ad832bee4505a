"""The LM of the dense family (GQA + SwiGLU: llama3.2-1b, chatglm3-6b,
internlm2-20b, h2o-danube-3-4b), of the moe family (GQA + a top-k MoE FFN:
granite-moe-1b-a400m, granite-moe-3b-a800m), of the ssm family (a
Mamba2/SSD stack, mamba2-370m) and of the hybrid family (Mamba2 blocks
with one shared attention block after every ``hybrid_attn_period`` of
them, zamba2-7b), ported from ``repro/models/transformer.py`` for serving
and training:

  * init(seed)                                -> params (stacked [L, ...])
  * loss(params, batch)                       -> (scalar loss, metrics)
  * forward_logits(params, tokens)            -> [B, S, vocab] f32
  * prefill(params, tokens, max_seq=...)      -> (last logits [B, vocab], cache)
  * decode_init(batch, max_seq)               -> KV and/or SSM cache
  * decode_step(params, cache, tokens, pos)   -> (logits [B, vocab], cache)

The layer stack is a Python loop over the stacked parameters (the
reference's ``lax.scan``). Prefill attention goes through the
flash-attention kernel and the prefill SSD scan through the SSD kernel;
the loss's attention through the forward and backward flash kernels and
its SSD scan through the forward and backward SSD kernels; decode and
the MoE layer's dense dispatch are plain torch, as in the reference. Other
families raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Params,
    embed,
    embedding_init,
    layer,
    linear_init,
    rms_norm,
    rms_norm_init,
    softmax_xent,
    swiglu,
    swiglu_init,
    unembed,
    unembed_separate,
    unstack,
)


FAMILIES = ("dense", "moe", "ssm", "hybrid")


class LM:
    def __init__(self, cfg: ModelConfig, *, ep_degree: int = 1, device=None,
                 attention=kops.flash_attention,
                 attention_bwd=kops.flash_attention_bwd,
                 ssd_scan=kops.ssd_scan, ssd_scan_bwd=kops.ssd_scan_bwd,
                 remat: bool = False):
        """``device``: 'cuda' (the default; raises without a card) or 'cpu'.
        ``attention``, ``attention_bwd``, ``ssd_scan`` and ``ssd_scan_bwd``:
        the attention forward and backward and the SSD scan and its
        backward; the kernels unless a comparison swaps in the plain
        versions. ``remat``: the loss recomputes each block's activations
        (Mamba or attention) in the backward (``torch.utils.checkpoint``),
        as the reference's ``remat``. ``ep_degree``: the moe family's
        experts are padded to a multiple of it (``cfg.padded_experts``), as
        in the reference; 1 on one card. ``routes``: set it to a list and
        each MoE layer appends its routing to it (``moe.moe_ffn``)."""
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not yet ported ({', '.join(FAMILIES)} only)")
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

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, seed: int = 0, param_dtype: torch.dtype | None = None) -> Params:
        """Seeded random params with the reference's distributions and dict
        paths (not its bits: torch and jax.random differ). Weights are stored
        in ``param_dtype`` (f32 master weights for training), by default in
        the config dtype, each cast as soon as it is drawn; the leaves of
        ``layers.F32_LEAVES`` are f32 either way. Every use casts a weight
        to the compute dtype, as the reference does."""
        c = self.cfg
        wd = param_dtype or self.dtype
        gen = torch.Generator(device=self.device).manual_seed(seed)
        extra: Params = {}
        if c.family == "ssm":
            layers = self._mamba_init(gen, c.num_layers, wd)
        elif c.family == "hybrid":
            groups, rem = divmod(c.num_layers, c.hybrid_attn_period)
            layers = self._mamba_init(gen, groups * c.hybrid_attn_period, wd)
            if rem:
                extra["tail_layers"] = self._mamba_init(gen, rem, wd)
            extra["shared_attn"] = self._block_init(gen, 0, wd)
        else:
            layers = self._block_init(gen, c.num_layers, wd)
        params: Params = {
            "embed": embedding_init(gen, c.vocab_size, c.d_model, dtype=wd),
            "final_ln": rms_norm_init(c.d_model, self.device),
            "layers": layers,
            **extra,
        }
        if not c.tie_embeddings:
            params["unembed"] = linear_init(gen, c.d_model, c.vocab_size, dtype=wd)
        return params

    def _block_init(self, gen: torch.Generator, n: int, dtype: torch.dtype) -> Params:
        """``n`` stacked attention + FFN blocks (one unstacked if 0): SwiGLU
        ``mlp``, or ``moe`` in the moe family."""
        c, dev = self.cfg, self.device
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

    def _mamba_init(self, gen: torch.Generator, n: int, dtype: torch.dtype) -> Params:
        """``n`` stacked Mamba2 blocks."""
        c = self.cfg
        return {
            "ln": rms_norm_init(c.d_model, self.device, stack=n),
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

    def _block_train(self, lp: Params, h: torch.Tensor):
        """An attention + FFN block for the loss: (h, aux or None)."""
        c = self.cfg
        h = h + attn.attention_train(
            lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps),
            attention=self.attention, attention_bwd=self.attention_bwd,
            **self._attn_kwargs())
        return self._ffn(lp, h)

    def _mamba(self, lp: Params, h: torch.Tensor,
               cache: Params | None = None) -> torch.Tensor:
        """One Mamba2 block with its residual, for the loss and prefill."""
        c = self.cfg
        return h + ssm_mod.ssd_block(
            lp["ssd"], rms_norm(lp["ln"], h, c.norm_eps),
            head_dim=c.ssm_head_dim, state=c.ssm_state, chunk=c.ssm_chunk,
            conv_width=c.ssm_conv_width, scan=self.ssd_scan,
            scan_bwd=self.ssd_scan_bwd, cache=cache)

    def loss(self, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: tokens [B,S], labels [B,S] (labels < 0 are masked). The
        mean token cross-entropy through the training attention and SSD
        scan plus 0.01 x ``moe_aux``, the MoE layers' aux losses summed over
        the stack (0 in the dense, ssm and hybrid families), and the
        reference's metrics. The blocks run in ``_stack``'s order; the
        hybrid's shared block runs under autograd at each call, so its
        gradients sum over the calls."""
        h = embed(params["embed"], batch["tokens"], self.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, lp, _ in self._stack(params, None):
            block = self._mamba if kind == "ssm" else self._block_train
            out = (checkpoint(block, lp, h, use_reentrant=False) if self.remat
                   else block(lp, h))
            h, a = (out, None) if kind == "ssm" else out
            if a is not None:
                aux = aux + a
        xent = softmax_xent(self._logits(params, h), batch["labels"])
        return xent + 0.01 * aux, {"xent": xent, "moe_aux": aux}

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
        MoE FFN) or "ssm" (a Mamba2 block). The hybrid family runs each group of
        ``hybrid_attn_period`` Mamba blocks, then the shared attention block
        on the group's own KV cache slot, and the tail blocks last. The
        stacked trees are taken apart by ``unstack``, so the loss's gradient
        of each is one stacked tensor."""
        c = self.cfg
        layers = unstack(params["layers"])

        def sub(key, i):
            return None if cache is None else layer(cache[key], i)

        if c.family in ("dense", "moe"):
            for i in range(c.num_layers):
                yield "attn", layers[i], sub("kv", i)
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
        tail = unstack(params["tail_layers"]) if "tail_layers" in params else []
        for i, lp in enumerate(tail):
            yield "ssm", lp, sub("ssm_tail", i)

    def _body(self, params: Params, h: torch.Tensor,
              cache: Params | None = None) -> torch.Tensor:
        """The layer stack at positions 0..S-1. With ``cache`` (from
        ``decode_init``), each attention block's rotated k and v, and each
        Mamba block's SSM state and conv windows, are written into it."""
        c = self.cfg
        S = h.shape[1]
        for kind, lp, sl in self._stack(params, cache):
            if kind == "ssm":
                h = self._mamba(lp, h, sl)
                continue
            a, k, v = attn.attention_prefill(
                lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps),
                attention=self.attention, **self._attn_kwargs())
            if sl is not None:
                self._fill_cache(sl, k, v, S)
            h, _ = self._ffn(lp, h + a)
        return h

    def _fill_cache(self, kv_slice: Params, k, v, S: int) -> None:
        T = kv_slice["k"].shape[1]
        if self.cfg.sliding_window > 0:  # ring buffer: the last T positions
            pos = torch.arange(max(0, S - T), S, device=k.device)
            slots = pos % T
        else:
            if S > T:
                raise ValueError(f"prompt of {S} tokens exceeds cache of {T}")
            pos = slots = torch.arange(S, device=k.device)
        kv_slice["k"][:, slots] = k[:, pos].to(kv_slice["k"].dtype)
        kv_slice["v"][:, slots] = v[:, pos].to(kv_slice["v"].dtype)

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = rms_norm(params["final_ln"], h, c.norm_eps)
        return (unembed(params["embed"], h) if c.tie_embeddings
                else unembed_separate(params["unembed"], h))

    def forward_logits(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Inference prefill: tokens [B,S] -> full-sequence f32 logits."""
        h = embed(params["embed"], tokens, self.dtype)
        return self._logits(params, self._body(params, h))

    def prefill(self, params: Params, tokens: torch.Tensor, *,
                max_seq: int | None = None, cache_dtype=None):
        """One pass over the prompt: returns (f32 logits of the last position
        [B, vocab], a cache of ``max_seq`` positions (default S) holding
        every attention block's rotated k/v at 0..S-1 and every Mamba
        block's f32 state after S tokens and conv windows). In the dense,
        ssm and hybrid families it equals stepping ``decode_step`` over the
        prompt from an empty cache. In the moe family it does only where no
        (token, choice) pair is dropped: the MoE layer routes the prompt in
        groups of up to 1024 tokens with a capacity a group, and a decode
        step routes its B tokens as one group, whose capacity at the
        configs' factor is ~1 slot an expert."""
        B, S = tokens.shape
        cache = self.decode_init(B, max_seq or S,
                                 dtype=cache_dtype or self.dtype)
        h = embed(params["embed"], tokens, self.dtype)
        h = self._body(params, h, cache)
        return self._logits(params, h[:, -1:])[:, 0], cache

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def decode_init(self, batch_size: int, max_seq: int,
                    dtype=torch.bfloat16) -> Params:
        """The reference's cache layout: ``kv`` [blocks, B, T, KV, hd] in
        ``dtype`` for the attention blocks (the hybrid family's shared block
        has one slot a group), T = min(max_seq, window) under a sliding
        window; ``ssm`` (and the hybrid tail's ``ssm_tail``) f32 state and
        conv windows whatever ``dtype`` is."""
        c = self.cfg

        def ssm(n):
            return ssm_mod.init_ssm_cache(
                batch_size, c.d_inner, c.ssm_head_dim, c.ssm_state,
                c.ssm_conv_width, device=self.device, stack=n)

        def kv(n):
            kv_len = (min(max_seq, c.sliding_window) if c.sliding_window > 0
                      else max_seq)
            shape = (n, batch_size, kv_len, c.num_kv_heads, c.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(shape, dtype=dtype, device=self.device)}

        if c.family == "ssm":
            return {"ssm": ssm(c.num_layers)}
        if c.family in ("dense", "moe"):
            return {"kv": kv(c.num_layers)}
        groups, rem = divmod(c.num_layers, c.hybrid_attn_period)
        cache = {"ssm": ssm(groups * c.hybrid_attn_period), "kv": kv(groups)}
        if rem:
            cache["ssm_tail"] = ssm(rem)
        return cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: int):
        """tokens: [B] int; pos: absolute position. Returns (logits [B, vocab]
        f32, cache); the cache is updated in place and returned."""
        c = self.cfg
        x = embed(params["embed"], tokens[:, None], self.dtype)  # [B,1,d]
        for kind, lp, sl in self._stack(params, cache):
            if kind == "ssm":
                x = x + ssm_mod.ssd_decode_step(
                    lp["ssd"], rms_norm(lp["ln"], x, c.norm_eps), sl,
                    head_dim=c.ssm_head_dim, state=c.ssm_state)
                continue
            a = attn.attention_decode(
                lp["attn"], rms_norm(lp["ln1"], x, c.norm_eps), sl, pos,
                **self._attn_kwargs())
            x, _ = self._ffn(lp, x + a)
        return self._logits(params, x)[:, 0, :], cache
