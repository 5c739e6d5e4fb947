"""GOOD: runtime guard as a real raise — survives python -O."""


def launch(lib, code):
    if code != 0:
        raise RuntimeError("kernel launch failed")
    return lib
