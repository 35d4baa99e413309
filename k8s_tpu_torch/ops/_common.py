"""Shared helpers for the kernel layer: block picking, the device
dispatch rule, and the per-kernel launch counters."""

from __future__ import annotations

import torch

# The hand-written kernels: the forward ones the serving path runs, then
# the flash backward's two (dq, then dk/dv).
KERNELS = ("flash_fwd", "rms_norm", "flash_bwd_dq", "flash_bwd_dkv")

# Launches of each kernel, counted by its wrapper right where it launches
# (never on the plain path).  Plain ints: a run zeroes them with
# reset_launches() and reads them back with launches() to prove the path
# it drove went through the kernels.  A backward kernel's count appears
# here at its first launch.
LAUNCHES: dict[str, int] = {"flash_fwd": 0, "rms_norm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def launches() -> dict[str, int]:
    """Every kernel's count since the last reset."""
    return {name: LAUNCHES.get(name, 0) for name in KERNELS}


def pick_block(length: int, preferred: int) -> int:
    """Largest divisor of ``length`` that is <= preferred (>=1)."""
    b = min(preferred, length)
    while length % b:
        b -= 1
    return b


def use_plain(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True when every tensor lies on the CPU (take the
    plain PyTorch version), False when every tensor lies on a CUDA device
    (launch the kernel, which raises rather than fall back).  Anything
    else is an error."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return False
    raise ValueError(f"kernel inputs must all be on cpu or all on cuda, "
                     f"got {sorted(kinds)}")


def resolve_device(device) -> torch.device:
    """An entry point's device: ``cuda`` unless the caller asks for the
    CPU.  Asking for CUDA where there is none raises; nothing carries on
    on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev
