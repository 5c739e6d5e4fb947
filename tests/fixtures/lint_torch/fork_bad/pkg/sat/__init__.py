"""BAD: the package that holds the fork entry imports triton; Python runs
this before the entry module itself."""
import triton  # noqa: F401
