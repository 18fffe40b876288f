"""Minimal GeoPackage (OGC GPKG 1.2) writer on stdlib sqlite3.

The reference exports its mistie line-intersection QC as a GeoPackage via
geopandas/fiona when available (mistie_correction_segy.py:629-703, gated by
``backends.geopandas_enabled``). This repo has no GEOS/GDAL dependency, but
a GPKG is just a SQLite database with three registry tables and a
geometry-blob convention — point layers need none of GDAL, so the artifact
is produced unconditionally here. Readable by QGIS/GDAL/geopandas.

Spec subset implemented: feature tables of 2D POINT geometries, one SRS.
http://www.geopackage.org/spec/ (tables: gpkg_spatial_ref_sys,
gpkg_contents, gpkg_geometry_columns; GeoPackageBinaryHeader + WKB).

A copy of ``pseudo_3d_interpolation_tpu/io/gpkg.py`` (the port imports
nothing of the JAX package) whose layers are tables: a mapping of column
name to 1-D values, or a pandas DataFrame, so the writer needs no pandas.
"""

from __future__ import annotations

import datetime
import os
import sqlite3
import struct

import numpy as np

_APPLICATION_ID = 0x47504B47  # "GPKG"
_USER_VERSION = 10200  # GPKG 1.2

_WGS84_WKT = (
    'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
    '298.257223563]],PRIMEM["Greenwich",0],UNIT["degree",'
    '0.0174532925199433],AUTHORITY["EPSG","4326"]]'
)


def _gpkg_point_blob(x: float, y: float, srs_id: int) -> bytes:
    """GeoPackageBinary: 'GP' magic, version 0, flags 0x01 (little-endian,
    no envelope), srs_id, then little-endian WKB POINT."""
    header = b"GP" + bytes([0, 0x01]) + struct.pack("<i", srs_id)
    wkb = b"\x01" + struct.pack("<I", 1) + struct.pack("<dd", float(x), float(y))
    return header + wkb


def write_gpkg_points(path: str, layers: dict, srs_id: int = 4326,
                      srs_wkt: str | None = None,
                      srs_name: str | None = None) -> str:
    """Write point-feature layers into a new GeoPackage.

    ``layers``: layer name -> (table, x_column, y_column), a table being
    a mapping of column name to values or a DataFrame; every other
    column becomes a feature attribute (TEXT/REAL/INTEGER by dtype).
    Overwrites ``path``. Returns ``path``.
    """
    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        cur.execute(f"PRAGMA application_id = {_APPLICATION_ID}")
        cur.execute(f"PRAGMA user_version = {_USER_VERSION}")
        cur.execute(
            "CREATE TABLE gpkg_spatial_ref_sys (srs_name TEXT NOT NULL,"
            " srs_id INTEGER PRIMARY KEY, organization TEXT NOT NULL,"
            " organization_coordsys_id INTEGER NOT NULL,"
            " definition TEXT NOT NULL, description TEXT)")
        cur.executemany(
            "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            [("Undefined Cartesian SRS", -1, "NONE", -1, "undefined", None),
             ("Undefined Geographic SRS", 0, "NONE", 0, "undefined", None),
             ("WGS 84", 4326, "EPSG", 4326, _WGS84_WKT, None)])
        if srs_id not in (-1, 0, 4326):
            cur.execute(
                "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
                (srs_name or f"EPSG:{srs_id}", srs_id, "EPSG", srs_id,
                 srs_wkt or "undefined", None))
        cur.execute(
            "CREATE TABLE gpkg_contents (table_name TEXT PRIMARY KEY,"
            " data_type TEXT NOT NULL, identifier TEXT UNIQUE,"
            " description TEXT DEFAULT '',"
            " last_change DATETIME NOT NULL,"
            " min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE,"
            " srs_id INTEGER)")
        cur.execute(
            "CREATE TABLE gpkg_geometry_columns (table_name TEXT NOT NULL,"
            " column_name TEXT NOT NULL, geometry_type_name TEXT NOT NULL,"
            " srs_id INTEGER NOT NULL, z TINYINT NOT NULL,"
            " m TINYINT NOT NULL,"
            " CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name))")
        now = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%fZ")
        for name, (df, xcol, ycol) in layers.items():
            table = {str(c): np.asarray(df[c]) for c in df.keys()}
            attr_cols = [c for c in table if c not in (xcol, ycol)]
            defs = []
            for c in attr_cols:
                kind = table[c].dtype.kind
                sql_t = ("INTEGER" if kind in "iu"
                         else "REAL" if kind == "f" else "TEXT")
                defs.append(f'"{c}" {sql_t}')
            cur.execute(
                f'CREATE TABLE "{name}" (fid INTEGER PRIMARY KEY'
                " AUTOINCREMENT, geom BLOB"
                + ("".join(", " + d for d in defs)) + ")")
            xs = table[xcol].astype(float)
            ys = table[ycol].astype(float)
            cols = [table[c] for c in attr_cols]
            rows = [
                (_gpkg_point_blob(x, y, srs_id),
                 *[v.item() if hasattr(v := col[i], "item") else v
                   for col in cols])
                for i, (x, y) in enumerate(zip(xs, ys))
            ]
            ph = ",".join("?" * (1 + len(attr_cols)))
            cur.executemany(
                f'INSERT INTO "{name}" (geom'
                + ("".join(f', "{c}"' for c in attr_cols))
                + f") VALUES ({ph})", rows)
            cur.execute(
                "INSERT INTO gpkg_contents VALUES (?,?,?,?,?,?,?,?,?,?)",
                (name, "features", name, "", now,
                 float(xs.min()) if len(xs) else None,
                 float(ys.min()) if len(ys) else None,
                 float(xs.max()) if len(xs) else None,
                 float(ys.max()) if len(ys) else None,
                 srs_id))
            cur.execute(
                "INSERT INTO gpkg_geometry_columns VALUES (?,?,?,?,0,0)",
                (name, "geom", "POINT", srs_id))
        con.commit()
    finally:
        con.close()
    return path
