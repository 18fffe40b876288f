"""The mesh's collectives a cube (s): the device seconds of rank 0's
``mesh.*`` collective spans (the all_to_alls, gathers, broadcast and
reductions of ``parallel/mesh.py``), from the current stream's point
before each to its end, the wait for the peers included, summed and
averaged over the window's cubes. A mesh of one records none."""

from p3d_bench import spans


def read(ctx):
    got = spans.mean_over_cubes(ctx, spans.COLLECTIVES, spans.device_s)
    return None if got is None else (got, "s")
