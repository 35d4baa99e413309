"""PyTorch/CUDA port of k8s_tpu's compute half, for one NVIDIA H100.

The package mirrors ``k8s_tpu``'s layout module by module (``ops/``,
``models/``, ``launcher/``, ``util/``) so each port sits at its
counterpart's path.  It imports torch, numpy and the stdlib only: never
JAX, and nothing of ``k8s_tpu``, not even its JAX-free modules (it keeps
its own copies).

Kernels are written by hand for Hopper (``csrc/*.cu`` built with nvcc
at first use, or Triton).  Each kernel's wrapper follows the tensor's
device: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
