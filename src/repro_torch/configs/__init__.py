"""Architecture registry of the port: the ten architectures of the
reference's registry (``repro/configs/__init__.py``), each selectable by
name, and the reference's shape table (train / prefill / decode /
long-context), a copy of its lines 43-74."""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped). long_500k needs sub-quadratic attention."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 512k context needs sub-quadratic "
            "attention (see DESIGN.md §6)"
        )
    return True, ""


def all_cells():
    """Every (arch, shape) pair — 40 cells, with applicability flags."""
    for arch, cfg in sorted(REGISTRY.items()):
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape.name)
            yield arch, shape.name, ok, why


__all__ = ["ModelConfig", "REGISTRY", "SHAPES", "ShapeSpec", "all_cells", "get_config",
           "shape_applicable"]
