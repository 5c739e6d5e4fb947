from .ops import flip_update  # noqa: F401
from .ref import flip_update_ref  # noqa: F401
