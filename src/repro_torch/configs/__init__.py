"""Architecture registry of the port: the ten architectures of the
reference's registry (``repro/configs/__init__.py``), each selectable by
name."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.chatglm3_6b import CONFIG as chatglm3_6b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.h2o_danube_3_4b import CONFIG as h2o_danube_3_4b
from repro_torch.configs.internlm2_20b import CONFIG as internlm2_20b
from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b
from repro_torch.configs.llava_next_34b import CONFIG as llava_next_34b
from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in [
    llama3_2_1b, chatglm3_6b, internlm2_20b, h2o_danube_3_4b, mamba2_370m, zamba2_7b,
    granite_moe_1b_a400m, granite_moe_3b_a800m, whisper_medium, llava_next_34b]}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


__all__ = ["ModelConfig", "REGISTRY", "get_config"]
