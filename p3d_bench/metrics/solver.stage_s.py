"""The solve stage a cube (rfft, POCS on every slice, irfft): the
``solve`` wall of ``interpolate_time_cube_sharded(timings=)``, averaged
over the window's cubes (s)."""


def read(ctx):
    c = ctx["cubes"]
    return sum(w["solve"] for w in c) / len(c), "s"
