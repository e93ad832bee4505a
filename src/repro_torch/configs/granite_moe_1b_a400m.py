"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) per-expert
d_ff=512, vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    tie_embeddings=True,
)
