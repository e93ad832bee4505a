"""mamba2-370m [ssm]: 48L d_model=1024 attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)
