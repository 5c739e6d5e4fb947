from .ops import ssd_flops, ssd_scan  # noqa: F401
from .ref import ssd_ref  # noqa: F401
