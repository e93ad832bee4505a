"""PyTorch/CUDA port of the PCCL reproduction, for NVIDIA Hopper (sm_90a).

The JAX package ``repro`` is the reference; this package imports nothing of
it (numpy-only pieces it needs are copied here). Entry points run on
``cuda`` unless the caller asks for ``device="cpu"``.

Ported so far: the serving paths of the dense LM (llama3.2-1b), with
hand-written CUDA flash-attention forward kernels, and of the ssm LM
(mamba2-370m), with a hand-written CUDA SSD chunked-scan kernel; the
planner and the collective executor; and the dense LM's data-parallel
training step (``launch/train_lm.py``), through a hand-written CUDA
flash-attention backward kernel and PCCL's all-reduce, with checkpoints
(``checkpoint``) and the fault-tolerance runtime (``runtime``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
