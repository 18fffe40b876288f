"""Timing / profiling decorators.

Counterpart of ``pseudo_3d_interpolation_tpu/utils/timing.py``.
reference: pseudo_3D_interpolation/functions/utils.py:89-178 (timeit/profile).
These read the host clock around a call: for work on the card, prefer
``torch.profiler`` traces (the card runs asynchronously, so a host wall
covers a device step only once the caller synchronizes).
"""

from __future__ import annotations

import cProfile
import functools
import io
import pstats
import time

from .logging import xprint


def timeit(fn=None, *, label: str | None = None, verbosity: int | None = None):
    """Decorator printing wall-clock runtime of the wrapped callable."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            dt = time.perf_counter() - t0
            xprint(f"{label or f.__name__}: {dt:.3f} s", kind="debug", verbosity=verbosity)
            return out

        return wrapper

    return deco(fn) if fn is not None else deco


def profile(fn=None, *, path: str | None = None, n_top: int = 30):
    """Decorator running cProfile over the wrapped callable.

    Writes a ``.prof`` dump when ``path`` is given, else prints top entries.
    """

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            pr = cProfile.Profile()
            pr.enable()
            try:
                return f(*args, **kwargs)
            finally:
                pr.disable()
                if path:
                    pr.dump_stats(path)
                else:
                    s = io.StringIO()
                    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(n_top)
                    print(s.getvalue())

        return wrapper

    return deco(fn) if fn is not None else deco


def debug(fn):
    """Decorator printing call arguments + result (reference
    functions/utils.py debug decorator)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        xprint(f"{fn.__name__}({args!r}, {kwargs!r}) -> {out!r}", kind="debug")
        return out

    return wrapper


class block_timer:
    """Context manager measuring wall time of a block; ``.elapsed`` afterwards."""

    def __init__(self, label: str | None = None, verbose: bool = False):
        self.label = label
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose and self.label:
            xprint(f"{self.label}: {self.elapsed:.3f} s", kind="debug")
        return False
