"""whisper-medium [audio]: enc-dec, 24L decoder (+24L encoder) d_model=1024
16H (kv=16) d_ff=4096 vocab=51865. Conv/audio frontend is a STUB providing
precomputed frame embeddings [B, 1500, d] per the assignment.
[arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    frontend="audio_stub",
)
