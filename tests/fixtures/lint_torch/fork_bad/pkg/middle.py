from . import heavy  # noqa: F401
