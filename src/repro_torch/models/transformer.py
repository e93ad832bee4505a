"""The LM of the dense family (GQA + SwiGLU, e.g. llama3.2-1b) and of the
ssm family (a Mamba2/SSD stack, e.g. mamba2-370m), ported from
``repro/models/transformer.py`` for serving, and the dense family's loss
for training:

  * init(seed)                                -> params (stacked [L, ...])
  * loss(params, batch)                       -> (scalar loss, metrics)
  * forward_logits(params, tokens)            -> [B, S, vocab] f32
  * prefill(params, tokens, max_seq=...)      -> (last logits [B, vocab], cache)
  * decode_init(batch, max_seq)               -> KV cache or SSM cache
  * decode_step(params, cache, tokens, pos)   -> (logits [B, vocab], cache)

The layer stack is a Python loop over the stacked parameters (the
reference's ``lax.scan``). Prefill attention goes through the
flash-attention kernel and the prefill SSD scan through the SSD kernel;
the loss's attention through the forward and backward flash kernels;
decode is plain torch, as in the reference. Other families raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Params,
    cast_params,
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


FAMILIES = ("dense", "ssm")


class LM:
    def __init__(self, cfg: ModelConfig, *, device=None,
                 attention=kops.flash_attention,
                 attention_bwd=kops.flash_attention_bwd,
                 ssd_scan=kops.ssd_scan, remat: bool = False):
        """``device``: 'cuda' (the default; raises without a card) or 'cpu'.
        ``attention``, ``attention_bwd`` and ``ssd_scan``: the attention
        forward and backward and the SSD scan; the kernels unless a
        comparison swaps in the plain versions. ``remat``: the loss
        recomputes each block's activations in the backward
        (``torch.utils.checkpoint``), as the reference's ``remat``."""
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not yet ported ({', '.join(FAMILIES)} only)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.attention = attention
        self.attention_bwd = attention_bwd
        self.ssd_scan = ssd_scan
        self.remat = remat

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, seed: int = 0, param_dtype: torch.dtype | None = None) -> Params:
        """Seeded random params with the reference's distributions (not its
        bits: torch and jax.random differ). Weights are stored in
        ``param_dtype`` (f32 master weights for training), by default in the
        config dtype; the leaves of ``layers.F32_LEAVES`` in f32 either way.
        Every use casts a weight to the compute dtype, as the reference does."""
        c, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        L = c.num_layers
        if c.family == "ssm":
            layers = {
                "ln": rms_norm_init(c.d_model, dev, stack=L),
                "ssd": ssm_mod.ssd_init(gen, c.d_model, expand=c.ssm_expand,
                                        head_dim=c.ssm_head_dim,
                                        state=c.ssm_state,
                                        conv_width=c.ssm_conv_width, stack=L),
            }
        else:
            layers = {
                "ln1": rms_norm_init(c.d_model, dev, stack=L),
                "attn": attn.attention_init(gen, c.d_model, c.num_heads,
                                            c.num_kv_heads, c.head_dim,
                                            stack=L),
                "ln2": rms_norm_init(c.d_model, dev, stack=L),
                "mlp": swiglu_init(gen, c.d_model, c.d_ff, stack=L),
            }
        params: Params = {
            "embed": embedding_init(gen, c.vocab_size, c.d_model),
            "final_ln": rms_norm_init(c.d_model, dev),
            "layers": layers,
        }
        if not c.tie_embeddings:
            params["unembed"] = linear_init(gen, c.d_model, c.vocab_size)
        return cast_params(params, param_dtype or self.dtype)

    # ------------------------------------------------------------------
    # loss (train)
    # ------------------------------------------------------------------
    def _block_train(self, lp: Params, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = h + attn.attention_train(
            lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps),
            attention=self.attention, attention_bwd=self.attention_bwd,
            **self._attn_kwargs())
        return h + swiglu(lp["mlp"], rms_norm(lp["ln2"], h, c.norm_eps))

    def loss(self, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: tokens [B,S], labels [B,S] (labels < 0 are masked). The
        mean token cross-entropy through the training attention, and the
        reference's metrics (``moe_aux`` is 0 in the dense family)."""
        c = self.cfg
        if c.family != "dense":
            raise NotImplementedError(
                f"loss of the {c.family!r} family is not yet ported (dense only)")
        h = embed(params["embed"], batch["tokens"], self.dtype)
        for lp in unstack(params["layers"], c.num_layers):
            if self.remat:
                h = checkpoint(self._block_train, lp, h, use_reentrant=False)
            else:
                h = self._block_train(lp, h)
        xent = softmax_xent(self._logits(params, h), batch["labels"])
        aux = torch.zeros((), dtype=torch.float32, device=xent.device)
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

    def _body(self, params: Params, h: torch.Tensor,
              cache: Params | None = None) -> torch.Tensor:
        """The layer stack at positions 0..S-1. With ``cache`` (from
        ``decode_init``), each layer's rotated k and v, or its SSM state and
        conv windows, are written into it."""
        if self.cfg.family == "ssm":
            return self._body_ssm(params, h, cache)
        return self._body_dense(params, h, None if cache is None else cache["kv"])

    def _body_dense(self, params: Params, h: torch.Tensor,
                    kv: Params | None) -> torch.Tensor:
        c = self.cfg
        S = h.shape[1]
        for i in range(c.num_layers):
            lp = layer(params["layers"], i)
            a, k, v = attn.attention_prefill(
                lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps),
                attention=self.attention, **self._attn_kwargs())
            if kv is not None:
                self._fill_cache(layer(kv, i), k, v, S)
            h = h + a
            h = h + swiglu(lp["mlp"], rms_norm(lp["ln2"], h, c.norm_eps))
        return h

    def _body_ssm(self, params: Params, h: torch.Tensor,
                  cache: Params | None) -> torch.Tensor:
        c = self.cfg
        for i in range(c.num_layers):
            lp = layer(params["layers"], i)
            h = h + ssm_mod.ssd_block(
                lp["ssd"], rms_norm(lp["ln"], h, c.norm_eps),
                head_dim=c.ssm_head_dim, state=c.ssm_state, chunk=c.ssm_chunk,
                conv_width=c.ssm_conv_width, scan=self.ssd_scan,
                cache=None if cache is None else layer(cache["ssm"], i))
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
        every layer's rotated k/v at 0..S-1, or for the ssm family every
        layer's f32 state after S tokens and conv windows). Equals stepping
        ``decode_step`` over the prompt from an empty cache."""
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
        """The dense family's KV cache in ``dtype``; the ssm family's cache
        is f32 whatever ``dtype`` is, as in the reference."""
        c = self.cfg
        if c.family == "ssm":
            return {"ssm": ssm_mod.init_ssm_cache(
                batch_size, c.d_inner, c.ssm_head_dim, c.ssm_state,
                c.ssm_conv_width, device=self.device, stack=c.num_layers)}
        kv_len = (min(max_seq, c.sliding_window) if c.sliding_window > 0
                  else max_seq)
        shape = (c.num_layers, batch_size, kv_len, c.num_kv_heads, c.head_dim)
        return {"kv": {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
        }}

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: int):
        """tokens: [B] int; pos: absolute position. Returns (logits [B, vocab]
        f32, cache); the cache is updated in place and returned."""
        c = self.cfg
        x = embed(params["embed"], tokens[:, None], self.dtype)  # [B,1,d]
        for i in range(c.num_layers):
            lp = layer(params["layers"], i)
            if c.family == "ssm":
                x = x + ssm_mod.ssd_decode_step(
                    lp["ssd"], rms_norm(lp["ln"], x, c.norm_eps),
                    layer(cache["ssm"], i), head_dim=c.ssm_head_dim,
                    state=c.ssm_state)
                continue
            a = attn.attention_decode(
                lp["attn"], rms_norm(lp["ln1"], x, c.norm_eps),
                layer(cache["kv"], i), pos, **self._attn_kwargs())
            h = x + a
            x = h + swiglu(lp["mlp"], rms_norm(lp["ln2"], h, c.norm_eps))
        return self._logits(params, x)[:, 0, :], cache
