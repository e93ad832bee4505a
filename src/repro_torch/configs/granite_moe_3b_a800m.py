"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) per-expert
d_ff=512, vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    tie_embeddings=True,
)
