"""The port's hand-written CUDA kernels, their plain PyTorch versions, and the
backend dispatch in ``ops.py``."""
