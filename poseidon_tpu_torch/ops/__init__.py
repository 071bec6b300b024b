"""Ops of the port: PyTorch operators where the JAX package used XLA, and
hand-written CUDA kernels (``csrc/``) where it used Pallas."""
