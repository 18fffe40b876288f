"""Tidal harmonic prediction from constituent constants.

replaces: the ``tpxo-tide-prediction`` dependency of the reference's tide
step (tide_compensation_segy.py:35-38, 242-252). Given per-site harmonic
constants (amplitude + Greenwich phase lag per constituent, e.g. extracted
from the TPXO atlas or a local gauge analysis), synthesizes the tide:

    h(t) = Σ_k f_k(t) · H_k · cos( V_k(t) + u_k(t) − g_k )

with equilibrium arguments V from the standard mean longitudes
(s, h, p, N, p1 — Meeus/Doodson) and the classic nodal corrections f, u
for the major constituents. Accuracy matches standard tide tables to the
centimeter level for the dominant constituents.

Counterpart of ``pseudo_3d_interpolation_tpu/utils/tide.py``, on the host.
Times are numpy ``datetime64[ns]`` instead of pandas timestamps (the
card's machine has no pandas): :func:`tide_table`, whose result is a
DataFrame, imports pandas inside. The atlas files go through the port's
``io/ncio`` (h5py, imported there), so they are read and written only
where h5py is installed; the card's machine takes a CSV tide series
(:func:`read_tide_csv`).
"""

from __future__ import annotations

import csv
import warnings

import numpy as np

_EPOCH = np.datetime64("2000-01-01T12:00:00", "ns")


def _days_since_epoch(times) -> np.ndarray:
    """Days since 2000-01-01 12:00 UTC of ``times`` (anything
    ``numpy.datetime64`` takes, a scalar or an array), computed as
    pandas computes ``(times - epoch).total_seconds() / 86400``: the
    nanosecond difference over 1e9, then over 86400."""
    t = np.atleast_1d(np.asarray(times, "datetime64[ns]"))
    return (t - _EPOCH).astype(np.int64) / 1e9 / 86400.0


def read_tide_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """A CSV tide series (columns ``datetime``, UTC ISO 8601, and
    ``height`` in m) as (``datetime64[ns]`` times, float heights),
    sorted by time as ``DataFrame.sort_values`` sorts them. Times numpy
    cannot parse as ISO 8601 (``2023-05-01T09:00:00`` or with a space;
    pandas would also take other layouts) raise ``ValueError``."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    if rows and not {"datetime", "height"} <= set(rows[0]):
        raise ValueError(f"{path}: a tide CSV needs 'datetime' and 'height' "
                         f"columns, got {sorted(rows[0])}")
    stamps = []
    for r in rows:
        s = r["datetime"].strip()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                stamps.append(np.datetime64(s, "ns"))
        except (ValueError, DeprecationWarning, UserWarning):
            raise ValueError(
                f"{path}: tide time {s!r} is not an ISO 8601 UTC date-time "
                "without offset (YYYY-MM-DDTHH:MM:SS[.fff], 'T' or a space); "
                "this reader parses no other format") from None
    t = np.array(stamps, "datetime64[ns]")
    h = np.array([float(r["height"]) for r in rows], np.float64)
    order = np.argsort(t.astype(np.int64), kind="quicksort")
    return t[order], h[order]

# constituent speeds (degrees per mean solar hour) and Doodson-style
# equilibrium-argument coefficients (multiples of [T+h-s(τ), s, h, p, 90°])
# V = a1·τ' ... expressed via mean longitudes below.
_CONSTITUENTS = {
    # name: (speed deg/h, V(s,h,p) coefficients (n_T, n_s, n_h, n_p, phase_deg), nodal group)
    "M2": (28.9841042, (2, -2, 2, 0, 0), "M2"),
    "S2": (30.0000000, (2, 0, 0, 0, 0), None),
    "N2": (28.4397295, (2, -3, 2, 1, 0), "M2"),
    "2N2": (27.8953548, (2, -4, 2, 2, 0), "M2"),
    "K2": (30.0821373, (2, 0, 2, 0, 0), "K2"),
    "K1": (15.0410686, (1, 0, 1, 0, 90), "K1"),
    "O1": (13.9430356, (1, -2, 1, 0, -90), "O1"),
    "P1": (14.9589314, (1, 0, -1, 0, -90), None),
    "Q1": (13.3986609, (1, -3, 1, 1, -90), "O1"),
    "Mf": (1.0980331, (0, 2, 0, 0, 0), "Mf"),
    "Mm": (0.5443747, (0, 1, 0, -1, 0), "Mm"),
    "M4": (57.9682084, (4, -4, 4, 0, 0), "M4"),
    "MS4": (58.9841042, (4, -2, 2, 0, 0), "M2"),
    "MN4": (57.4238337, (4, -5, 4, 1, 0), "M4"),
}


def _mean_longitudes(t_days: np.ndarray):
    """Mean longitudes (degrees) of moon (s), sun (h), lunar perigee (p),
    ascending node (N), solar perigee (ps);
    ``t_days`` = days since 2000-01-01 12:00 UTC."""
    T = t_days / 36525.0
    s = 218.3164477 + 481267.88123421 * T
    h = 280.46645 + 36000.76983 * T
    p = 83.3532465 + 4069.0137287 * T
    N = 125.04452 - 1934.13626197 * T
    ps = 282.93735 + 1.71946 * T
    return s % 360, h % 360, p % 360, N % 360, ps % 360


def _nodal_corrections(N_deg: np.ndarray):
    """Standard nodal factors f and angles u (degrees) by group."""
    N = np.deg2rad(N_deg)
    f = {
        "M2": 1.000 - 0.037 * np.cos(N),
        "K1": 1.006 + 0.115 * np.cos(N),
        "O1": 1.009 + 0.187 * np.cos(N),
        "K2": 1.024 + 0.286 * np.cos(N),
        "Mf": 1.043 + 0.414 * np.cos(N),
        "Mm": 1.000 - 0.130 * np.cos(N),
    }
    u = {
        "M2": np.rad2deg(-0.037 * np.sin(N)) * (1.0 / 1.0),
        "K1": np.rad2deg(-0.156 * np.sin(N)),
        "O1": np.rad2deg(0.189 * np.sin(N)),
        "K2": np.rad2deg(-0.310 * np.sin(N)),
        "Mf": np.rad2deg(-0.414 * np.sin(N)),
        "Mm": np.zeros_like(N),
    }
    f["M4"] = f["M2"] ** 2
    u["M4"] = 2 * u["M2"]
    return f, u


# ---------------------------------------------------------------------------
# Minor-constituent inference (admittance interpolation)
#
# replaces: the ``correct_minor`` option of the reference's
# tpxo-tide-prediction dependency (tide_compensation_segy.py:242-252):
# sixteen minor constituents inferred from the eight majors by the standard
# linear-admittance scheme (Schureman arguments; the same weight table the
# OTPS/pyTMD family uses). Each minor's equilibrium argument is
# V = n_T·τ + n_s·s + n_h·h + n_p·p + n_ps·ps + phase0 — validated against
# the published speeds in tests/test_tide_crs.py. eps2/eta2 are omitted
# (negligible and their admittance sits outside the interpolated band).
# ---------------------------------------------------------------------------
_MINOR_CONSTITUENTS = {
    # name: (speed deg/h, (n_T, n_s, n_h, n_p, n_ps, phase_deg), nodal kind)
    "2Q1": (12.8542862, (1, -4, 1, 2, 0, -90), "O1m"),
    "sigma1": (12.9271398, (1, -4, 3, 0, 0, -90), "O1m"),
    "rho1": (13.4715145, (1, -3, 3, -1, 0, -90), "O1m"),
    "M12": (14.4874103, (1, -1, 1, -1, 0, 90), "M1m"),
    "M11": (14.4966939, (1, -1, 1, 1, 0, 90), "M1m"),
    "chi1": (14.5695476, (1, -1, 3, -1, 0, 90), "M1m"),
    "pi1": (14.9178647, (1, 0, -2, 0, 1, -90), None),
    "phi1": (15.1232059, (1, 0, 3, 0, 0, 90), None),
    "theta1": (15.5125897, (1, 1, -1, 1, 0, 90), "J1m"),
    "J1": (15.5854433, (1, 1, 1, -1, 0, 90), "J1m"),
    "OO1": (16.1391017, (1, 2, 1, 0, 0, 90), "OO1m"),
    "2N2m": (27.8953548, (2, -4, 2, 2, 0, 0), "M2m"),
    "mu2": (27.9682084, (2, -4, 4, 0, 0, 0), "M2m"),
    "nu2": (28.5125831, (2, -3, 4, -1, 0, 0), "M2m"),
    "lambda2": (29.4556253, (2, -1, 0, 1, 0, 180), "M2m"),
    "L2": (29.5284789, (2, -1, 2, -1, 0, 180), "M2m"),
    "t2": (29.9589333, (2, 0, -1, 0, 1, 0), None),
}

# minor z = w1·z[src1] + w2·z[src2] (complex admittance; OTPS weights)
_MINOR_ADMITTANCE = {
    "2Q1": (("Q1", 0.263), ("O1", -0.0252)),
    "sigma1": (("Q1", 0.297), ("O1", -0.0264)),
    "rho1": (("Q1", 0.164), ("O1", 0.0048)),
    "M12": (("O1", 0.0140), ("K1", 0.0101)),
    "M11": (("O1", 0.0389), ("K1", 0.0282)),
    "chi1": (("O1", 0.0064), ("K1", 0.0060)),
    "pi1": (("O1", 0.0030), ("K1", 0.0171)),
    "phi1": (("O1", -0.0015), ("K1", 0.0152)),
    "theta1": (("O1", -0.0065), ("K1", 0.0155)),
    "J1": (("O1", -0.0389), ("K1", 0.0836)),
    "OO1": (("O1", -0.0431), ("K1", 0.0613)),
    "2N2m": (("N2", 0.264), ("M2", -0.0253)),
    "mu2": (("N2", 0.298), ("M2", -0.0264)),
    "nu2": (("N2", 0.165), ("M2", 0.00487)),
    "lambda2": (("M2", 0.0040), ("S2", 0.0074)),
    "L2": (("M2", 0.0131), ("S2", 0.0326)),
    "t2": (("M2", 0.0033), ("S2", 0.0082)),
}


def _minor_nodal(kind: str | None, N_deg: np.ndarray):
    """Schureman nodal factor/angle for a minor-constituent kind."""
    if kind is None:
        one = np.ones_like(N_deg)
        return one, np.zeros_like(N_deg)
    N = np.deg2rad(N_deg)
    sinn, cosn = np.sin(N), np.cos(N)
    coef = {"O1m": 0.189, "M1m": 0.185, "J1m": 0.198}
    if kind in coef:
        k = coef[kind]
        f = np.hypot(1.0 + k * cosn, k * sinn)
        u = np.rad2deg(np.arctan2(k * sinn, 1.0 + k * cosn))
        return f, u
    if kind == "OO1m":
        re = 1.0 + 0.640 * cosn + 0.134 * np.cos(2 * N)
        im = 0.640 * sinn + 0.134 * np.sin(2 * N)
        return np.hypot(re, im), np.rad2deg(np.arctan2(im, re))
    if kind == "M2m":
        f = np.hypot(1.0 - 0.0373 * cosn, 0.0373 * sinn)
        u = np.rad2deg(-np.arctan2(0.0373 * sinn, 1.0 - 0.0373 * cosn))
        return f, u
    raise ValueError(f"unknown minor nodal kind {kind!r}")


def _minor_heights(z_major: dict, tau, s, h, p, ps, N_deg) -> np.ndarray:
    """Sum of inferred minor-constituent heights.

    ``z_major``: {NAME: complex A·e^{-ig}} (scalars or per-sample arrays) —
    minors whose both admittance sources are present are synthesized;
    a minor is skipped when its major is already in ``z_major`` under its
    major-table name (e.g. 2N2 supplied explicitly).
    """
    zu = {k.upper(): v for k, v in z_major.items()}
    total = np.zeros(np.shape(tau), float)
    for name, ((s1, w1), (s2, w2)) in _MINOR_ADMITTANCE.items():
        if s1 not in zu or s2 not in zu:
            continue
        if name.rstrip("m").upper() in zu:  # explicitly supplied major
            continue
        z = w1 * zu[s1] + w2 * zu[s2]
        _, (nT, ns_, nh, np_, nps, ph0), kind = _MINOR_CONSTITUENTS[name]
        f, u = _minor_nodal(kind, N_deg)
        V = nT * tau + ns_ * s + nh * h + np_ * p + nps * ps + ph0
        total = total + f * np.real(z * np.exp(1j * np.deg2rad(V + u)))
    return total


def predict_tide(times, constituents: dict[str, tuple[float, float]],
                 mean_level: float = 0.0, correct_minor: bool = False) -> np.ndarray:
    """Predict tide heights (m) at UTC ``times``.

    ``constituents``: {name: (amplitude_m, greenwich_phase_deg)} with names
    from the supported set; unknown names raise. ``correct_minor`` adds the
    sixteen admittance-inferred minor constituents (reference
    tpxo-tide-prediction ``correct_minor``; see ``_MINOR_CONSTITUENTS``).
    """
    t_days = _days_since_epoch(times)
    hours_utc = (t_days - np.floor(t_days)) * 24.0 + 12.0  # hours of UTC day

    s, hl, p, N, ps = _mean_longitudes(t_days)
    fs, us = _nodal_corrections(N)
    # solar-time formulation: T = 15°·(UTC hours); constituent argument
    # V = n_T·T + n_s·s + n_h·h + n_p·p + phase0 (speeds check out, e.g.
    # M2: 2·15 − 2·ds/dt + 2·dh/dt = 28.9841 °/h)
    tau = 15.0 * hours_utc

    h_total = np.full(t_days.shape, float(mean_level))
    for name, (amp, g) in constituents.items():
        if name not in _CONSTITUENTS:
            raise ValueError(
                f"unknown constituent {name!r}; supported: {sorted(_CONSTITUENTS)}"
            )
        _, (nT, ns_, nh, np_, ph0), group = _CONSTITUENTS[name]
        V = nT * tau + ns_ * s + nh * hl + np_ * p + ph0
        f = fs.get(group, np.ones_like(t_days)) if group else np.ones_like(t_days)
        u = us.get(group, np.zeros_like(t_days)) if group else np.zeros_like(t_days)
        h_total = h_total + f * amp * np.cos(np.deg2rad(V + u - g))
    if correct_minor:
        z = {n: a * np.exp(-1j * np.deg2rad(g))
             for n, (a, g) in constituents.items()}
        h_total = h_total + _minor_heights(z, tau, s, hl, p, ps, N)
    return h_total


def tide_table(start, end, constituents, freq: str = "600s",
               mean_level: float = 0.0):
    """Convenience: a DataFrame(datetime, height) directly usable by the
    tide-compensation step (pandas, imported here)."""
    import pandas as pd

    times = pd.date_range(start, end, freq=freq)
    return pd.DataFrame({"datetime": times,
                         "height": predict_tide(times, constituents, mean_level)})


# ---------------------------------------------------------------------------
# Spatial (atlas-based) prediction
#
# replaces: the reference's TPXO9-atlas path — tide predicted at per-trace
# lat/lon/time (tide_compensation_segy.py:77-143, 242-252) — without the
# tpxo-tide-prediction dependency. The atlas is a gridded set of harmonic
# constants: per constituent, amplitude (m) and Greenwich phase lag (deg)
# maps over (lat, lon). Constants are bilinearly interpolated at each trace
# position as COMPLEX numbers A·e^{-ig} (interpolating amplitude and phase
# separately is wrong where the phase wraps — same convention as the TPXO
# tools), then synthesized per trace time with nodal corrections.
# ---------------------------------------------------------------------------

class TideAtlas:
    """Gridded harmonic constants: {name: (amp(lat,lon), phase_deg(lat,lon))}.

    NaN cells mark land/invalid nodes; interpolation renormalizes over the
    valid corners of each cell (positions inside fully-invalid cells raise).
    """

    def __init__(self, lat: np.ndarray, lon: np.ndarray,
                 constituents: dict[str, tuple[np.ndarray, np.ndarray]]):
        self.lat = np.asarray(lat, float)
        self.lon = np.asarray(lon, float)
        if not (np.all(np.diff(self.lat) > 0) and np.all(np.diff(self.lon) > 0)):
            raise ValueError("atlas lat/lon axes must be strictly increasing")
        self.constituents = {}
        for name, (amp, ph) in constituents.items():
            if name not in _CONSTITUENTS:
                raise ValueError(f"unknown constituent {name!r}; supported: "
                                 f"{sorted(_CONSTITUENTS)}")
            amp = np.asarray(amp, float)
            ph = np.asarray(ph, float)
            if amp.shape != (len(self.lat), len(self.lon)):
                raise ValueError(f"{name}: amp grid {amp.shape} != "
                                 f"({len(self.lat)}, {len(self.lon)})")
            self.constituents[name] = (amp, ph)

    # -- persistence (ncio cube convention: <NAME>_amp / <NAME>_phase) --
    def save(self, path: str) -> None:
        from ..io.ncio import Cube, write_cube

        data_vars = {}
        for name, (amp, ph) in self.constituents.items():
            data_vars[f"{name}_amp"] = (("lat", "lon"), amp.astype(np.float32))
            data_vars[f"{name}_phase"] = (("lat", "lon"), ph.astype(np.float32))
        write_cube(path, Cube(coords={"lat": self.lat, "lon": self.lon},
                              data_vars=data_vars,
                              attrs={"title": "tidal harmonic constant atlas"}))

    @classmethod
    def from_file(cls, path: str) -> "TideAtlas":
        from ..io.ncio import read_cube

        cube = read_cube(path)
        cons = {}
        for k in cube.data_vars:
            if k.endswith("_amp"):
                name = k[:-4]
                if f"{name}_phase" in cube.data_vars:
                    cons[name] = (cube[k], cube[f"{name}_phase"])
        if not cons:
            raise ValueError(f"{path}: no <NAME>_amp/<NAME>_phase variable "
                             "pairs found — not a tide atlas")
        return cls(cube.coords["lat"], cube.coords["lon"], cons)

    def _bilinear_complex(self, grid_c: np.ndarray, lats, lons) -> np.ndarray:
        """Masked bilinear interpolation of a complex grid at query points.

        Out-of-grid positions clamp to the border (matches nearest-edge
        behavior of atlas tools for coastal surveys at the grid rim).
        """
        lats = np.clip(np.asarray(lats, float), self.lat[0], self.lat[-1])
        lons = np.clip(np.asarray(lons, float), self.lon[0], self.lon[-1])
        iy = np.clip(np.searchsorted(self.lat, lats) - 1, 0, len(self.lat) - 2)
        ix = np.clip(np.searchsorted(self.lon, lons) - 1, 0, len(self.lon) - 2)
        wy = (lats - self.lat[iy]) / (self.lat[iy + 1] - self.lat[iy])
        wx = (lons - self.lon[ix]) / (self.lon[ix + 1] - self.lon[ix])
        vals = np.zeros(lats.shape, complex)
        wsum = np.zeros(lats.shape, float)
        for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                          (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
            c = grid_c[iy + dy, ix + dx]
            ok = np.isfinite(c)
            vals += np.where(ok, c, 0.0) * w * ok
            wsum += w * ok
        if (wsum <= 0).any():
            raise ValueError("tide atlas: query positions fall in fully "
                             "invalid (land) atlas cells")
        return vals / wsum

    def predict(self, times, lats, lons, constituents=None,
                correct_minor: bool = False) -> np.ndarray:
        """Tide height (m) at each (time, lat, lon) triple (equal lengths).

        The spatial analogue of :func:`predict_tide`: constants vary per
        position, astronomy varies per time. ``constituents`` restricts the
        synthesis to a subset of the atlas's constituents (case-insensitive
        names; reference ``--constituents``); ``correct_minor`` adds the
        admittance-inferred minors (reference ``--correct_minor``).
        """
        t_days = _days_since_epoch(times)
        hours_utc = (t_days - np.floor(t_days)) * 24.0 + 12.0
        s, hl, p, N, ps = _mean_longitudes(t_days)
        fs, us = _nodal_corrections(N)
        tau = 15.0 * hours_utc

        use = self.constituents
        if constituents is not None:
            want = {c.upper() for c in constituents}
            use = {n: v for n, v in use.items() if n.upper() in want}
            missing = want - {n.upper() for n in use}
            if missing:
                raise ValueError(f"constituents not in atlas: {sorted(missing)}")

        h_total = np.zeros(t_days.shape, float)
        z_at = {}
        for name, (amp, ph) in use.items():
            _, (nT, ns_, nh, np_, ph0), group = _CONSTITUENTS[name]
            c = self._bilinear_complex(
                amp * np.exp(-1j * np.deg2rad(ph)), lats, lons)
            z_at[name] = c
            V = nT * tau + ns_ * s + nh * hl + np_ * p + ph0
            f = fs.get(group, 1.0) if group else 1.0
            u = us.get(group, 0.0) if group else 0.0
            # A·cos(V+u−g) == Re[(A·e^{-ig}) · e^{i(V+u)}]
            h_total = h_total + f * np.real(
                c * np.exp(1j * np.deg2rad(V + u)))
        if correct_minor:
            h_total = h_total + _minor_heights(z_at, tau, s, hl, p, ps, N)
        return h_total
