from .ops import (ROUTES, reset_counts, true_counts,  # noqa: F401
                  true_counts_window)
from .ref import true_counts_ref, true_counts_window_ref  # noqa: F401
