"""Stage 2's host-to-device copies (GB/s): the bytes of a cube's
``stage2.h2d`` spans (this rank's block of the time cube, the mask) over
their device seconds, averaged over the window's cubes."""

from p3d_bench import spans


def read(ctx):
    got = spans.mean_over_cubes(
        ctx, {"stage2.h2d"}, lambda s: spans.gigabytes(s) / spans.device_s(s))
    return None if got is None else (got, "GB/s")
