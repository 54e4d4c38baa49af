"""The port's decode kernels: CUDA sources in csrc/, wrappers, plain versions, registry."""
