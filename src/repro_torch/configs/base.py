"""Model configuration schema covering all assigned architecture families:
dense / MoE / SSM / hybrid / enc-dec / VLM-backbone / audio-backbone.

A copy of ``repro/configs/base.py`` (numpy-free, jax-free): the port keeps
its own so that it imports nothing of the JAX package. The parity tests
check that both give the same fields and parameter counts."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert FFN width (granite: 512)
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0  # N (state size per head)
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128  # SSD chunk length

    # --- attention flavor ---
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # chatglm3 uses 0.5 ("RoPE 2d" partial rotary)
    sliding_window: int = 0  # >0 enables SWA (h2o-danube)
    attn_logit_softcap: float = 0.0

    # --- hybrid (zamba2): shared attention block every K mamba blocks ---
    hybrid_attn_period: int = 0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper audio frames after conv frontend (stub)

    # --- modality frontends (stubs per assignment) ---
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_patches: int = 0  # vision stub: prepended patch embeddings (anyres)

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def padded_experts(self, ep: int) -> int:
        """Experts padded up to a multiple of the expert-parallel degree
        (granite-3b: 40 -> 48 on a 16-way axis); pad experts receive -inf
        router logits and are never selected."""
        if self.num_experts == 0:
            return 0
        return ((self.num_experts + ep - 1) // ep) * ep

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.is_moe:
            small.update(num_experts=4, experts_per_token=2, moe_d_ff=64)
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
        if self.family == "hybrid":
            small.update(num_layers=4, hybrid_attn_period=2)
        if self.is_encoder_decoder:
            small.update(encoder_layers=2, encoder_seq=8)
        if self.frontend == "vision_stub":
            small.update(num_patches=4)
        small.update(overrides)
        return dataclasses.replace(self, **small)

    # ------------------------------------------------------------------
    # analytic parameter counts (for roofline MODEL_FLOPS = 6*N*D)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    qo = 2 * cfg.d_model * cfg.num_heads * cfg.head_dim
    kv = 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    return qo + kv


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d

    def dense_ffn():
        return 3 * d * cfg.d_ff  # SwiGLU

    def moe_ffn():
        e = cfg.experts_per_token if active_only else cfg.num_experts
        return e * 3 * d * cfg.moe_d_ff + d * cfg.num_experts  # + router

    def mamba_block():
        di, n = cfg.d_inner, cfg.ssm_state
        heads = cfg.ssm_heads
        in_proj = d * (2 * di + 2 * n * heads // cfg.ssm_heads * heads + heads)
        # simplified: in_proj ~ d*(2*di + 2*n_groups*n + heads); use n_groups=1
        in_proj = d * (2 * di + 2 * n + heads)
        return in_proj + di * cfg.ssm_conv_width + di * d + 2 * di

    per_layer_norms = 2 * d
    if cfg.family == "ssm":
        total += cfg.num_layers * (mamba_block() + per_layer_norms)
    elif cfg.family == "hybrid":
        total += cfg.num_layers * (mamba_block() + per_layer_norms)
        total += _attn_params(cfg) + dense_ffn() + per_layer_norms  # shared block
    elif cfg.is_encoder_decoder:
        enc = cfg.encoder_layers * (_attn_params(cfg) + dense_ffn() + per_layer_norms)
        dec = cfg.num_layers * (
            2 * _attn_params(cfg) + dense_ffn() + 3 * d  # self + cross attn
        )
        total += enc + dec
    elif cfg.is_moe:
        total += cfg.num_layers * (_attn_params(cfg) + moe_ffn() + per_layer_norms)
    else:
        total += cfg.num_layers * (_attn_params(cfg) + dense_ffn() + per_layer_norms)
    return int(total)
