"""The POCS batches a cube (s): the device seconds of its
``solver.batch`` spans (one a ``pocs_interpolate`` launch of stage 2's
``_solve_block``), summed, averaged over the window's cubes."""

from p3d_bench import spans


def read(ctx):
    got = spans.mean_over_cubes(ctx, {"solver.batch"}, spans.device_s)
    return None if got is None else (got, "s")
