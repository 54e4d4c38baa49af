"""PyTorch and CUDA port of the parallel block-based Viterbi decoder.

A second package beside the JAX reference ``repro``: the same modules and
names, plain PyTorch around hand-written CUDA kernels for the H100. It
imports torch and numpy, never JAX and nothing of ``repro``.
"""
