from .ops import (flip_update, reset_counts, walk_chunk,  # noqa: F401
                  walk_route)
from .ref import flip_update_ref, walk_chunk_ref  # noqa: F401
