"""The LM of the port: config, head plan, layers and the ``LM`` module
(copies of the JAX package's ``repro.models`` in torch)."""
