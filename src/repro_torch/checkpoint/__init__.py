"""Checkpoints of the port's training path, in the JAX package's on-disk
format (``repro.checkpoint``), so that either package restores the
other's."""
