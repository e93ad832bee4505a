"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 blocks + shared attention block (weights
reused at every invocation). [arXiv:2411.15242; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_period=6,  # shared block every 6 mamba blocks (13 invocations)
)
