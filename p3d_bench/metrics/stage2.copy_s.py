"""Stage 2's copies a cube: the upload and download walls of
``interpolate_time_cube_sharded(timings=)``, averaged over the window's
cubes (s)."""


def read(ctx):
    c = ctx["cubes"]
    return sum(w["upload"] + w["download"] for w in c) / len(c), "s"
