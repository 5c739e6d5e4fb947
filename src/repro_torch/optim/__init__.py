"""The optimizer of the port's training path (a copy of the JAX package's
``repro.optim`` in torch)."""
