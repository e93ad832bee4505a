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


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


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
        elif c.family == "encdec":
            extra["enc_layers"] = self._block_init(gen, c.encoder_layers, wd)
            extra["enc_ln"] = rms_norm_init(c.d_model, self.device)
            layers = self._decoder_init(gen, c.num_layers, wd)
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

    def _decoder_init(self, gen: torch.Generator, n: int, dtype: torch.dtype) -> Params:
        """``n`` stacked decoder blocks of the encdec family: self-attention,
        cross-attention (``xattn``, normed by ``ln_x``) and SwiGLU."""
        c, dev = self.cfg, self.device

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
        h, enc = self._inputs(params, batch["tokens"], batch.get("frames"),
                              batch.get("patches"), train=True)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, lp, _ in self._stack(params, None):
            if kind == "ssm":
                h = self._run(self._mamba, lp, h)
                continue
            h, a = (self._run(self._decoder_train, lp, h, enc) if kind == "dec"
                    else self._run(self._block_train, lp, h))
            if a is not None:
                aux = aux + a
        h = h[:, h.shape[1] - batch["tokens"].shape[1]:]  # the vlm's token positions
        xent = softmax_xent(self._logits(params, h), batch["labels"])
        return xent + 0.01 * aux, {"xent": xent, "moe_aux": aux}

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
        h = embed(params["embed"], tokens, self.dtype)
        given = {"frames": frames is not None, "patches": patches is not None}
        wanted = {"frames": c.family == "encdec", "patches": c.family == "vlm"}
        if given != wanted:
            raise ValueError(f"the {c.family} family takes "
                             f"{[k for k, w in wanted.items() if w] or 'no stub inputs'}; "
                             f"got {[k for k, g in given.items() if g]}")
        if c.family == "vlm":
            h = torch.cat([patches.to(self.dtype), h], dim=1)
        if c.family != "encdec":
            return h, None
        return h, self._encode(params, frames.to(self.dtype), train)

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
        layers = unstack(params["layers"])

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
        tail = unstack(params["tail_layers"]) if "tail_layers" in params else []
        for i, lp in enumerate(tail):
            yield "ssm", lp, sub("ssm_tail", i)

    def _body(self, params: Params, h: torch.Tensor, cache: Params | None = None,
              enc: torch.Tensor | None = None) -> torch.Tensor:
        """The layer stack at positions 0..L-1, over the encoder output
        ``enc`` in the encdec family. With ``cache`` (from ``decode_init``),
        each attention block's rotated k and v, each decoder block's cross
        k and v of ``enc``, and each Mamba block's SSM state and conv
        windows are written into it."""
        c = self.cfg
        L = h.shape[1]
        for kind, lp, sl in self._stack(params, cache):
            if kind == "ssm":
                h = self._mamba(lp, h, sl)
                continue
            a, k, v = attn.attention_prefill(
                lp["attn"], rms_norm(lp["ln1"], h, c.norm_eps),
                attention=self.attention, **self._attn_kwargs())
            kv_slice = sl["kv"] if kind == "dec" and sl is not None else sl
            if kv_slice is not None:
                self._fill_cache(kv_slice, k, v, L)
            h = h + a
            if kind == "dec":
                ck, cv = self._cross_kv(lp, enc)
                if sl is not None:
                    sl["cross"]["k"].copy_(ck)
                    sl["cross"]["v"].copy_(cv)
                h = h + attn.cross_attention(
                    lp["xattn"], rms_norm(lp["ln_x"], h, c.norm_eps), (ck, cv),
                    num_heads=c.num_heads, head_dim=c.head_dim, attention=self.attention)
            h, _ = self._ffn(lp, h)
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

    def forward_logits(self, params: Params, tokens: torch.Tensor, *,
                       frames: torch.Tensor | None = None,
                       patches: torch.Tensor | None = None) -> torch.Tensor:
        """Inference prefill: tokens [B,S] (with the family's stub input)
        -> the tokens' f32 logits [B,S,vocab]."""
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
        ``dtype`` is."""
        c = self.cfg

        def ssm(n):
            return ssm_mod.init_ssm_cache(
                batch_size, c.d_inner, c.ssm_head_dim, c.ssm_state,
                c.ssm_conv_width, device=self.device, stack=n)

        def kv(n, kv_len=None):
            kv_len = kv_len or (min(max_seq, c.sliding_window) if c.sliding_window > 0
                                else max_seq)
            shape = (n, batch_size, kv_len, c.num_kv_heads, c.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(shape, dtype=dtype, device=self.device)}

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
        f32, cache); the cache is updated in place and returned."""
        c = self.cfg
        x = embed(params["embed"], tokens[:, None], self.dtype)  # [B,1,d]
        for kind, lp, sl in self._stack(params, cache):
            if kind == "ssm":
                x = x + ssm_mod.ssd_decode_step(
                    lp["ssd"], rms_norm(lp["ln"], x, c.norm_eps), sl,
                    head_dim=c.ssm_head_dim, state=c.ssm_state)
                continue
            kv_slice = sl["kv"] if kind == "dec" else sl
            x = x + attn.attention_decode(
                lp["attn"], rms_norm(lp["ln1"], x, c.norm_eps), kv_slice, pos,
                **self._attn_kwargs())
            if kind == "dec":
                x = x + attn.cross_attention(
                    lp["xattn"], rms_norm(lp["ln_x"], x, c.norm_eps),
                    (sl["cross"]["k"], sl["cross"]["v"]), num_heads=c.num_heads,
                    head_dim=c.head_dim)
            x, _ = self._ffn(lp, x)
        return self._logits(params, x)[:, 0, :], cache
