"""PyTorch/CUDA port of k8s_tpu's compute half, for one NVIDIA H100.

The package mirrors ``k8s_tpu``'s layout module by module (``ops/``,
``models/``, ``parallel/``, ``launcher/``, ``e2e/``, ``util/``) so each
port sits at its counterpart's path.  It imports torch, numpy and the stdlib only: never
JAX, and nothing of ``k8s_tpu``, not even its JAX-free modules (it keeps
its own copies).

Kernels are written by hand for Hopper in CUDA C++ (``csrc/*.cu``, built
with nvcc at first use).  Each kernel's wrapper follows the tensor's
device: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (or the pod env's ``K8S_TPU_PLATFORM``
names the CPU); a job of more processes trains data-parallel over
``torch.distributed`` (NCCL on CUDA, gloo on the CPU).
"""
