"""PyTorch + CUDA port of the JAX package ``repro`` (so far: the
``IterativeGP`` fit → optimize → predict path on CG, and fit → predict on the
stochastic solvers SGD, SDD and AP).

It imports ``torch``, never ``jax``, and nothing of ``repro``; only the parity
tests import both. Entry points run on the card unless the caller passes
``device="cpu"`` (see ``repro_torch.device.resolve_device``).
"""
