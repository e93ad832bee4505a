"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2D RoPE (partial rotary 0.5), GQA. [arXiv:2406.12793; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rotary_pct=0.5,  # "RoPE 2d": rotate only half of each head
)
