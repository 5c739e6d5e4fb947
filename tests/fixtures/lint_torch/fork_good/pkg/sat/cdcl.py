"""Fork entrypoint with a torch-free module-scope closure."""
from ..walk import run_on_device  # noqa: F401
