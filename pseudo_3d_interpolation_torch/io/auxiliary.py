"""Auxiliary-file plumbing: datalists, .nav/.tid/.mst/.sta sidecars,
navigation extraction from SEG-Y headers.

Counterpart of ``pseudo_3d_interpolation_tpu/io/auxiliary.py``.
reference: pseudo_3D_interpolation/functions/utils_IO.py. A "path" may be
(a) a single SEG-Y file, (b) a directory (with optional prefix/suffix
filters), or (c) a ``.txt`` datalist of relative filenames. Sidecar files
are CSVs named after the profile with a different suffix.

The card's machine has no pandas, so the sidecars are written and read
with the stdlib ``csv`` module: a table is a mapping of column name to
1-D array (a ``pandas.DataFrame`` is accepted wherever a table is taken).
:func:`write_aux` writes the columns in order, as
``DataFrame.to_csv(index=False)`` does, each float as its shortest
round-trip repr. The two helpers whose result is a DataFrame
(:func:`read_auxiliary_files`, :func:`extract_navigation`) import pandas
inside; the steps and ``p3d-torch nav`` use the column forms beside them
(:func:`read_auxiliary_columns`, :func:`navigation_table`).
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np

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


# ---------------------------------------------------------------------------
# tables as column mappings
# ---------------------------------------------------------------------------
def table_columns(table) -> dict:
    """A table (a mapping of column name to 1-D values, or a DataFrame)
    as an ordered dict of numpy columns."""
    return {str(k): np.asarray(table[k]) for k in table.keys()}


def table_rows(table) -> int:
    cols = table_columns(table)
    return len(next(iter(cols.values()))) if cols else 0


def _cell(v):
    """One CSV cell as ``DataFrame.to_csv`` writes it: ints as ints,
    floats as their shortest round-trip repr, NaN as an empty cell."""
    if isinstance(v, (np.bool_, bool)):
        return str(bool(v))
    if isinstance(v, (np.integer, int)):
        return str(int(v))
    if isinstance(v, (np.floating, float)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def write_csv(path: str, table) -> str:
    """Write a table as CSV: a header of the column names, one row per
    entry, no index column."""
    cols = table_columns(table)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(list(cols))
        for row in zip(*cols.values()):
            w.writerow([_cell(v) for v in row])
    return path


def _parse_column(values: list[str]) -> np.ndarray:
    """A CSV column as numbers where every cell is one (ints stay
    ints), else as strings."""
    try:
        return np.array([int(v) for v in values], np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(v) if v != "" else np.nan for v in values],
                        np.float64)
    except ValueError:
        return np.array(values, dtype=object)


def read_csv_columns(path: str) -> dict:
    """Read a CSV written by :func:`write_csv` (or ``to_csv``) into an
    ordered dict of numpy columns."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        return {}
    head, body = rows[0], rows[1:]
    return {name: _parse_column([r[k] for r in body])
            for k, name in enumerate(head)}


def write_aux(segy_path: str, suffix: str, df) -> str:
    """Write a sidecar CSV (.nav/.tid/.mst/.sta/...) from a table."""
    return write_csv(aux_path(segy_path, suffix), df)


def _aux_files(path, fsuffix: str, prefix: str | None = None,
               suffix: str | None = None) -> list[str]:
    fs = fsuffix if fsuffix.startswith(".") else "." + fsuffix
    if os.path.isdir(str(path)):
        # same directory-scan contract as resolve_input_files — one source
        # of truth for the prefix/suffix filter semantics
        return resolve_input_files(str(path), fsuffix=fs, fnprefix=prefix,
                                   fnsuffix=suffix)
    segys = resolve_input_files(path)
    files = [aux_path(p, fs) for p in segys]
    return [f for f in files if os.path.exists(f)]


def read_auxiliary_columns(path, fsuffix: str, prefix: str | None = None,
                           suffix: str | None = None,
                           splitter: str = "UTM") -> dict | None:
    """The sidecar CSVs of :func:`read_auxiliary_files`, without pandas:
    ``{line name: columns}``, the rows of a line's files concatenated in
    file order. None when there is no sidecar."""
    files = _aux_files(path, fsuffix, prefix, suffix)
    if not files:
        return None
    out: dict = {}
    for f in files:
        cols = read_csv_columns(f)
        ln = line_name(f, splitter)
        if ln in out:
            prev = out[ln]
            out[ln] = {k: np.concatenate([prev[k], cols[k]]) for k in prev}
        else:
            out[ln] = cols
    return out


def read_auxiliary_files(path, fsuffix: str, prefix: str | None = None,
                         suffix: str | None = None,
                         index_cols=("line", "tracl"),
                         splitter: str = "UTM"):
    """Read + merge sidecar CSVs into one DataFrame keyed by (line, tracl)
    (pandas, imported here)."""
    import pandas as pd

    files = _aux_files(path, fsuffix, prefix, suffix)
    if not files:
        return None
    frames = []
    for f in files:
        df = pd.read_csv(f)
        df["line"] = line_name(f, splitter)
        frames.append(df)
    out = pd.concat(frames, ignore_index=True)
    if index_cols:
        out = out.set_index(list(index_cols), drop=True)
    return out


def _json_value(v):
    # numpy scalars to Python ones (json.dump rejects np.int64); NaN to null
    if isinstance(v, (np.floating, float)) and np.isnan(v):
        return None
    return v.item() if hasattr(v, "item") else v


def export_coords(df, out_path: str, fmt: str | None = None) -> str:
    """Export navigation coordinates from a table (columns ``x``, ``y``,
    optionally ``line``) to CSV or GeoJSON (reference utils_IO.py:129-187;
    GeoJSON replaces the geopandas path — plain-text, no GEOS
    dependency): one LineString per line, sorted by line name, or one
    Point per row without a ``line`` column."""
    fmt = fmt or ("geojson" if out_path.endswith((".geojson", ".json"))
                  else "csv")
    if fmt == "csv":
        return write_csv(out_path, df)
    if fmt != "geojson":
        raise ValueError("fmt must be 'csv' or 'geojson'")
    cols = table_columns(df)
    features = []
    if "line" in cols:
        lines = cols["line"]
        for line in sorted(set(lines.tolist())):
            sel = lines == line
            coords = [[float(x), float(y)]
                      for x, y in zip(cols["x"][sel], cols["y"][sel])]
            features.append({
                "type": "Feature",
                "properties": {"line": str(line), "n_traces": int(sel.sum())},
                "geometry": {"type": "LineString", "coordinates": coords},
            })
    else:
        props = [k for k in cols if k not in ("x", "y")]
        for i in range(table_rows(cols)):
            features.append({
                "type": "Feature",
                "properties": {k: _json_value(cols[k][i]) for k in props},
                "geometry": {"type": "Point",
                             "coordinates": [float(cols["x"][i]),
                                             float(cols["y"][i])]},
            })
    with open(out_path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": features}, f)
    return out_path


def navigation_table(path, fsuffix: str = "sgy", fnprefix=None,
                     fnsuffix=None, splitter: str = "UTM",
                     src_coords_bytes=(73, 77),
                     write_sidecars: bool = False) -> dict:
    """Scrape per-trace navigation from SEG-Y headers into a table of
    columns ``tracl``, ``x``, ``y``, ``line``, ``file`` (1-D arrays, the
    profiles' rows in file order), without pandas: the columns of
    :func:`extract_navigation`'s DataFrame."""
    from .headers import scale_coordinates
    from .segy import SegyFile

    files = resolve_input_files(path, fsuffix, fnprefix, fnsuffix)
    parts = []
    for p in files:
        with SegyFile(p) as f:
            x, y, _ = scale_coordinates(f, src_coords_bytes)
            tracl = f.header("TRACE_SEQUENCE_FILE")
            if not tracl.any():
                tracl = np.arange(1, f.n_traces + 1)
        if write_sidecars:
            write_aux(p, ".nav", {"tracl": tracl, "x": x, "y": y})
        parts.append({"tracl": tracl, "x": x, "y": y,
                      "line": np.full(len(x), line_name(p, splitter),
                                      dtype=object),
                      "file": np.full(len(x), p, dtype=object)})
    if not parts:
        raise FileNotFoundError(f"no SEG-Y files found under {path!r}")
    return {k: np.concatenate([part[k] for part in parts])
            for k in parts[0]}


def extract_navigation(path, fsuffix: str = "sgy", fnprefix=None,
                       fnsuffix=None, splitter: str = "UTM",
                       src_coords_bytes=(73, 77),
                       write_sidecars: bool = False):
    """Scrape per-trace navigation (x, y, tracl, line) from SEG-Y headers
    into a DataFrame (reference utils_IO.py:190-293; pandas, imported
    here): :func:`navigation_table` as a DataFrame."""
    import pandas as pd

    return pd.DataFrame(navigation_table(
        path, fsuffix, fnprefix, fnsuffix, splitter, src_coords_bytes,
        write_sidecars))
