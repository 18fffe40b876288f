"""Stage 2's host time a cube: the host-to-host wall less the upload,
solve and download walls (the host ``Cube`` in and out, the mask, the
moveaxis), averaged over the window's cubes (s)."""


def read(ctx):
    c = ctx["cubes"]
    return sum(w["cube"] - w["upload"] - w["solve"] - w["download"]
               for w in c) / len(c), "s"
