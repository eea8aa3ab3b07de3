"""Kernel ops of the port, each a hand-written CUDA kernel for Hopper
(``csrc/``) beside its plain PyTorch version: fused flash attention with
its default policy and the dense einsum attention, and GGUF
dequantization. ``_build`` builds and loads the kernel libraries."""
