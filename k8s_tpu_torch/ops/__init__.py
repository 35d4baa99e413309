"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``flash_attention`` (CUDA C++, csrc/flash_fwd.cu) and ``fused_norm``
(Triton)."""
