from .ops import true_counts, true_counts_window  # noqa: F401
from .ref import true_counts_ref, true_counts_window_ref  # noqa: F401
