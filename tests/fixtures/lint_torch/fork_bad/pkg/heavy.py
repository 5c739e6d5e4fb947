"""BAD: module-scope torch import, two hops from the fork entrypoint."""
import torch  # noqa: F401
