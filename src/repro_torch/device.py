"""The one device setting of the port.

Every entry point that puts work on an accelerator (today the probSAT walk)
asks :func:`resolve_device` where to run. The default is ``cuda``; a caller
that wants the CPU says so with ``set_default_device("cpu")``, as the CPU
tests do. Asking for ``cuda`` where there is none raises
:class:`DeviceUnavailable`: nothing quietly continues on the CPU.

torch is imported only inside these functions, so that importing the
mapper (and the CDCL worker that the solver pool forks) stays torch-free.
"""
from __future__ import annotations

_DEFAULT = "cuda"


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def _check(device):
    import torch
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {str(device)!r}: "
                                f"expected 'cuda' or 'cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "repro_torch runs on cuda by default and this machine has no "
            "CUDA device; call repro_torch.set_default_device('cpu') to run "
            "on the CPU")
    return device


def set_default_device(device) -> None:
    """Pick where the port's walks run: ``"cuda"`` (the default, one card)
    or ``"cpu"``. Raises :class:`DeviceUnavailable` for a device this
    machine does not have."""
    global _DEFAULT
    _DEFAULT = str(_check(device))


def get_default_device() -> str:
    return _DEFAULT


def resolve_device():
    """The ``torch.device`` the next walk runs on; raises
    :class:`DeviceUnavailable` if this machine does not have it."""
    return _check(_DEFAULT)
