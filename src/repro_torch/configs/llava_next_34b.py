"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; anyres tiling (vision frontend is a stub providing precomputed
patch embeddings per the assignment).
[hf:llava-hf/llava-v1.6-mistral-7b-hf family; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision_stub",
    num_patches=2880,  # anyres: base 576 + 4 tiles x 576
)
