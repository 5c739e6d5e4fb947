"""The synthetic data pipeline of the port's training path (a copy of the
JAX package's ``repro.data`` with a numpy generator)."""
