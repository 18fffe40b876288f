"""The mesh's collective bytes a cube (GB): the ``bytes`` of rank 0's
input buffers to its ``mesh.*`` collective spans, summed, averaged over
the window's cubes. A mesh of one records none."""

from p3d_bench import spans


def read(ctx):
    got = spans.mean_over_cubes(ctx, spans.COLLECTIVES, spans.gigabytes)
    return None if got is None else (got, "GB")
