"""The plain torch version of the kernel."""


def foo_ref(x):
    return x.float().sum()
