"""Leveled, colored console logging.

Re-design of the reference's ``xprint`` logger and log-file
hygiene utilities (reference: pseudo_3D_interpolation/functions/utils.py:57-86).

A copy of ``pseudo_3d_interpolation_tpu/utils/logging.py``, kept here:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sys

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")

_COLORS = {
    "info": "\x1b[0m",  # default
    "warning": "\x1b[33m",  # yellow
    "error": "\x1b[31m",  # red
    "success": "\x1b[32m",  # green
    "debug": "\x1b[36m",  # cyan
}
_RESET = "\x1b[0m"

# Minimum verbosity at which each kind prints.
_THRESHOLD = {"error": 0, "warning": 0, "success": 1, "info": 1, "debug": 2}

_GLOBAL_VERBOSITY = 1


def set_verbosity(level: int) -> None:
    """Set the module-wide default verbosity (0=quiet, 1=normal, 2=debug)."""
    global _GLOBAL_VERBOSITY
    _GLOBAL_VERBOSITY = int(level)


def xprint(*args, kind: str = "info", verbosity: int | None = None, file=None, **kwargs) -> None:
    """Print a leveled, colored message.

    Parameters
    ----------
    kind
        One of ``info | warning | error | success | debug``.
    verbosity
        Verbosity of the current run; message prints when
        ``verbosity >= threshold(kind)``. Defaults to the global verbosity.
    """
    kind = kind.lower()
    if kind not in _COLORS:
        kind = "info"
    v = _GLOBAL_VERBOSITY if verbosity is None else int(verbosity)
    if v < _THRESHOLD[kind]:
        return
    out = file if file is not None else sys.stdout
    color = _COLORS[kind] if getattr(out, "isatty", lambda: False)() else ""
    reset = _RESET if color else ""
    tag = {"warning": "[WARNING] ", "error": "[ERROR]   ", "success": "[SUCCESS] ",
           "debug": "[DEBUG]   ", "info": "[INFO]    "}[kind]
    print(color + tag + " ".join(str(a) for a in args) + reset, file=out, **kwargs)


def clean_log_file(path: str) -> None:
    """Strip ANSI escape codes from a log file in place.

    reference: pseudo_3D_interpolation/functions/utils.py:79-86
    """
    with open(path, "r", errors="replace") as f:
        content = f.read()
    with open(path, "w", newline="\n") as f:
        f.write(_ANSI_RE.sub("", content))


@contextlib.contextmanager
def redirect_stdout_to_file(path: str, also_console: bool = False):
    """Redirect stdout to a logfile for batch runs; ANSI codes are stripped on exit.

    reference pattern: pseudo_3D_interpolation/merge_segys.py:421-426.
    """

    class _Tee(io.TextIOBase):
        def __init__(self, *streams):
            self.streams = streams

        def write(self, s):
            for st in self.streams:
                st.write(s)
            return len(s)

        def flush(self):
            for st in self.streams:
                st.flush()

    old = sys.stdout
    try:
        with open(path, "w", newline="\n") as fh:
            sys.stdout = _Tee(fh, old) if also_console else fh
            try:
                yield
            finally:
                sys.stdout = old
    finally:
        # strip ANSI even when the block raised — failed-run logs are
        # exactly the ones a user inspects; guard existence so a failed
        # open() (or a log removed mid-run) doesn't raise a second
        # exception here that replaces the original traceback
        if os.path.exists(path):
            clean_log_file(path)
