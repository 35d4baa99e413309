"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``flash_attention`` (CUDA C++: csrc/flash_fwd.cu forward, csrc/flash_bwd.cuh
backward) and ``fused_norm`` (CUDA C++: csrc/rms_norm.cu); ``fused_ce`` is
plain PyTorch, as its reference has no kernel."""
