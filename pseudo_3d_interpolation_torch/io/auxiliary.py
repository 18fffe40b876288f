"""Input-file plumbing: the file, directory or datalist a step reads, a
profile's line name and its sidecar paths.

Counterpart of part of ``pseudo_3d_interpolation_tpu/io/auxiliary.py``:
``resolve_input_files``, ``line_name`` and ``aux_path``, copied. The
pandas helpers there (``read_auxiliary_files``, ``extract_navigation``,
``export_coords``) belong to stage 1 and are not ported yet.

reference: pseudo_3D_interpolation/functions/utils_IO.py. A "path" may be
(a) a single SEG-Y file, (b) a directory (with optional prefix/suffix
filters), or (c) a ``.txt`` datalist of relative filenames. Sidecar files
are named after the profile with a different suffix.
"""

from __future__ import annotations

import glob
import os

SEGY_SUFFIXES = (".sgy", ".segy")


def resolve_input_files(path, fsuffix: str = "sgy", fnprefix: str | None = None,
                        fnsuffix: str | None = None) -> list[str]:
    """Resolve a file / directory / datalist input into a file list
    (shared stage-1 input contract; reference utils_IO.py:58-126)."""
    if isinstance(path, (list, tuple)):
        return [str(p) for p in path]
    path = str(path)
    if os.path.isdir(path):
        pat = fsuffix if fsuffix.startswith(".") else "." + fsuffix
        # glob.escape: a directory named cruise[2020] must not become a
        # character class. The default 'sgy' also matches '.segy' — both
        # spellings are standard (SEGY_SUFFIXES).
        pats = SEGY_SUFFIXES if pat == ".sgy" else (pat,)
        files = sorted(
            f for p in pats
            for f in glob.glob(os.path.join(glob.escape(path), f"*{p}")))
        if fnprefix:
            files = [f for f in files if os.path.basename(f).startswith(fnprefix)]
        if fnsuffix:
            files = [
                f for f in files
                if os.path.splitext(os.path.basename(f))[0].endswith(fnsuffix)
            ]
        return files
    if os.path.isfile(path) and path.endswith(".txt"):
        base = os.path.dirname(path)
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                out.append(line if os.path.isabs(line) else os.path.join(base, line))
        return out
    if os.path.isfile(path):
        return [path]
    raise IOError(f"Invalid input path {path!r}: not a file, directory, or datalist")


def line_name(filepath: str, splitter: str = "UTM") -> str:
    """Derive the original line name from a filename: everything before the
    first '_'-separated token containing ``splitter``
    (reference utils_IO.py:14-55)."""
    base = os.path.splitext(os.path.basename(filepath))[0]
    parts = base.split("_")
    for i, p in enumerate(parts):
        if splitter in p:
            # splitter-first names ('UTM33N_line1') would derive the empty
            # string and collapse DISTINCT profiles onto one (line, tracl)
            # key, silently mis-joining sidecars — fall back to the full
            # stem instead (deviation: the reference returns '' here,
            # utils_IO.py:47-51)
            return "_".join(parts[:i]) if i > 0 else base
    return base


def aux_path(segy_path: str, suffix: str) -> str:
    """Sidecar path for a profile (same basename, different suffix)."""
    suffix = suffix if suffix.startswith(".") else "." + suffix
    return os.path.splitext(segy_path)[0] + suffix
