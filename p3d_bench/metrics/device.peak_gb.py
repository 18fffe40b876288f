"""The device's peak allocation over one traced cube
(``max_memory_allocated`` after ``reset_peak_memory_stats``), GB."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return tr["peak_bytes"] / 1e9, "GB"
