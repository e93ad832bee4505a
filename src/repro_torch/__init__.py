"""PyTorch/CUDA port of the PCCL reproduction, for NVIDIA Hopper (sm_90a).

The JAX package ``repro`` is the reference; this package imports nothing of
it (numpy-only pieces it needs are copied here). Entry points run on
``cuda`` unless the caller asks for ``device="cpu"``.

Ported so far: the serving path of the dense LM (llama3.2-1b) with a
hand-written CUDA flash-attention forward kernel.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
