"""BAD: runtime guard as a bare assert — vanishes under python -O."""


def launch(lib, code):
    assert code == 0, "kernel launch failed"
    return lib
