"""PyTorch/CUDA port of photon_tpu (GLM and GLMix training) for NVIDIA Hopper.

A package of its own beside ``photon_tpu``, which stays the reference it is
checked against. It imports torch and numpy, never jax or photon_tpu. Its
layout mirrors the reference (``ops/``, ``optim/``, ``data/``,
``parallel/``); the reference's three Pallas kernels are CUDA C++ kernels
in ``csrc/``, built at first use (``ops/kernels.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On
CPU tensors every kernel wrapper computes its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""
