"""Device selection for the port.

The kernel wrappers in ``ops/`` choose between a CUDA kernel and its plain
PyTorch version by the device of the tensor they are given (replacing the
reference's ``_interpret()`` backend probe): a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back
from CUDA to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["require_device", "on_cuda"]

# the kernels are built for sm_90a (Hopper)
MIN_CAPABILITY = (9, 0)


def require_device(device) -> torch.device:
    """Validate ``device`` and return it as a ``torch.device`` with an
    explicit index for CUDA. ``"cuda"`` without a visible GPU, or on a card
    below capability 9.0, raises ``RuntimeError``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA GPU is visible")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            f"the kernels need {MIN_CAPABILITY} (Hopper) or newer"
        )
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` must go through a CUDA kernel, False for the plain
    CPU version; any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensor on unsupported device {t.device}")
