"""PyTorch/CUDA port of the SAT-MapIt mapper (``repro`` is the JAX reference).

    import repro_torch
    from repro_torch import MapRequest, compile
    res = compile(MapRequest(dfg=g, arch="4x4", sweep_width=4))

The walk runs on ``cuda`` unless ``set_default_device("cpu")`` was called.
This package imports torch and numpy, never jax and nothing of ``repro``.
"""
from .core import (ArchSpec, CGRA, Infeasible, MapperConfig, MapRequest,  # noqa: F401
                   MappingResult, arch, compile)
from .core.mapper import IIAttempt  # noqa: F401
from .device import (DeviceUnavailable, get_default_device,  # noqa: F401
                     set_default_device)
