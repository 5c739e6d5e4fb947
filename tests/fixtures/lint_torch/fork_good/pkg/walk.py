"""GOOD: the torch import lives inside a function, which the forked CDCL
worker never calls."""


def run_on_device(x):
    import torch
    return torch.as_tensor(x)
