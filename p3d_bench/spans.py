"""The program's spans in the window's cubes: ``timings["spans"]`` and
``timings["process"]`` of ``interpolate_time_cube_sharded``, as its
``utils.timing`` records them (rank 0's), for the per-layer metrics that
read them. A program that records no spans, or a cube whose spans have no
device seconds (off the card), gives None."""

from __future__ import annotations

COLLECTIVES = frozenset({"mesh.all_to_all", "mesh.all_gather",
                         "mesh.broadcast", "mesh.all_reduce"})


def named(cube: dict, names) -> list | None:
    """The cube's spans named in ``names`` (builds left out), or None
    where it has none or one of them lacks its device seconds."""
    got = [s for s in cube.get("spans", ())
           if s["name"] in names and not s["build"]]
    if not got or any(s["device_s"] is None for s in got):
        return None
    return got


def mean_over_cubes(ctx, names, value) -> float | None:
    """``value(spans)`` of each window cube's spans named in ``names``,
    averaged over the cubes; None where a cube has none to read."""
    values = []
    for cube in ctx["cubes"]:
        got = named(cube, names)
        if got is None:
            return None
        values.append(value(got))
    return sum(values) / len(values)


def device_s(spans) -> float:
    return sum(s["device_s"] for s in spans)


def gigabytes(spans) -> float:
    return sum(s["attrs"]["bytes"] for s in spans) / 1e9
