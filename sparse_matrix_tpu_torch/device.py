"""Device selection for the port.

The kernel wrappers in ``ops/`` choose between a CUDA kernel and its plain
PyTorch version by the device of the tensor they are given (replacing the
reference's ``_interpret()`` backend probe): a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back
from CUDA to the CPU.

Entry points take an explicit ``device``. The one exception is
``spgemm_auto`` (and through it ``CsrMatrix.__matmul__``), which, given
none, runs on :func:`default_device`: ``"cuda"`` unless the caller has
set another with :func:`set_default_device`. It is the counterpart of the
JAX backend the reference's ``spgemm_auto`` consults, so ``A @ B`` on a
machine without a Hopper card raises unless ``"cpu"`` was set.
"""

from __future__ import annotations

import torch

__all__ = ["require_device", "on_cuda", "default_device", "set_default_device"]

# the kernels are built for sm_90a (Hopper)
MIN_CAPABILITY = (9, 0)

_DEFAULT = "cuda"


def default_device() -> torch.device:
    """The device of an ``A @ B`` that names none, validated by
    :func:`require_device` at each call."""
    return require_device(_DEFAULT)


def set_default_device(dev) -> None:
    """Set the device ``A @ B`` and ``spgemm_auto(device=None)`` run on
    (validated now and at each use)."""
    global _DEFAULT
    require_device(dev)
    _DEFAULT = str(torch.device(dev))


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
