"""BAD wrapper: no ref.py beside it, a double-precision dtype, and a
handler that falls back to another route instead of raising."""
import torch

from .kernel import launch


def foo(x):
    acc = x.to(torch.float64)
    try:
        return launch(acc)
    except RuntimeError:
        return acc.sum()
