"""Attention ops: the fused flash kernel (CUDA for Hopper) with its plain
PyTorch version, the default policy, and the dense einsum attention."""
