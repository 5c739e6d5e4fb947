"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package, each split as ``kernel.py`` (the CUDA launch) + ``ops.py``
(checks, dispatch, launch count) + ``ref.py`` (the plain torch version).
The CUDA sources live in ``csrc/``; ``_cuda`` builds and loads them."""
