from .ops import flash_attention, flash_route, reset_counts  # noqa: F401
from .ref import attention_ref  # noqa: F401
