"""PyTorch/CUDA port of the communication-free parallel sLDA system.

The JAX package `repro` is the reference; this package computes the same
algorithms with PyTorch on the CPU (plain tensor code) or on an NVIDIA
Hopper card (hand-written CUDA kernels for the two sampler sweeps).  It
imports neither `jax` nor anything of `repro`.

Every entry point takes `device=` and defaults to "cuda"; without a CUDA
device it raises unless the caller asks for the CPU (`device="cpu"`).
"""
