"""Fork entrypoint: its module-scope import closure reaches torch."""
from ..middle import something  # noqa: F401
