"""Kernel binding (stands in for a ctypes-loaded CUDA library)."""


class KernelError(RuntimeError):
    pass


def launch(x):
    return x
