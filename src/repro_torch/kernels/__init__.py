"""Hand-written CUDA kernels of the port (``csrc/``), their build, their
wrappers with launch counts, and their plain PyTorch versions (``ref.py``).
Use them through ``ops``."""
