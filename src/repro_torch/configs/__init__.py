"""Architecture registry of the port: only the architectures whose model
family has been ported are selectable."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b
from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in [llama3_2_1b, mamba2_370m]}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"arch {arch!r} not yet ported; ported: {sorted(REGISTRY)}")
    return REGISTRY[arch]


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
