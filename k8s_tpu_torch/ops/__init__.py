"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``flash_attention`` (CUDA C++: csrc/flash_fwd.cu forward, csrc/flash_bwd.cu
backward) and ``fused_norm`` (Triton); ``fused_ce`` is plain PyTorch, as
its reference has no kernel."""
