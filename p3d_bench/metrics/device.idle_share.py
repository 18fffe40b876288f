"""The device's idle share of one traced cube: 1 - the union of its
kernel, memcpy and memset intervals over the cube's host-to-host wall."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 1.0 - tr["busy"] / tr["wall"], "fraction"
