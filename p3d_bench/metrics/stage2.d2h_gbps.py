"""Stage 2's device-to-host copy (GB/s): the bytes of a cube's
``stage2.d2h`` span (the gathered result) over its device seconds,
averaged over the window's cubes."""

from p3d_bench import spans


def read(ctx):
    got = spans.mean_over_cubes(
        ctx, {"stage2.d2h"}, lambda s: spans.gigabytes(s) / spans.device_s(s))
    return None if got is None else (got, "GB/s")
