from repro_torch.models.transformer import LM

__all__ = ["LM"]
