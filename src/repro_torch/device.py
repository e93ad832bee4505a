"""Device resolution: the card by default, the CPU only on request."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, raising if there is
    none; ``"cpu"`` -> the CPU. Never falls back from one to the other."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
