"""GOOD wrapper: launches on a CUDA tensor, takes ref.py on a CPU tensor,
and re-raises a failed launch."""
import torch

from .kernel import KernelError, launch
from .ref import foo_ref


def foo(x):
    if x.device.type == "cpu":
        return foo_ref(x)
    try:
        return launch(x.to(torch.float32))
    except OSError as err:
        raise KernelError(f"foo failed: {err}") from err
