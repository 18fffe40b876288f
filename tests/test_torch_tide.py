"""The port's tide module (``utils/tide.py``: numpy times, no pandas on
its path) against the JAX package's: harmonic prediction with and
without the minor constituents, ``tide_table``, the atlas interpolation
and its file round trip, and the CSV reader. Heights are held to 1e-12 m
(both are float64 numpy; the times reach them through the same integer
nanoseconds)."""

import numpy as np
import pandas as pd
import pytest

from pseudo_3d_interpolation_tpu.utils import tide as jtide
from pseudo_3d_interpolation_torch.utils import tide

MAJORS = {"M2": (1.2, 40.0), "S2": (0.4, 75.0), "N2": (0.25, 20.0),
          "K1": (0.1, 200.0), "O1": (0.08, 180.0), "Q1": (0.02, 170.0),
          "P1": (0.03, 198.0), "K2": (0.1, 80.0)}
TOL = 1e-12


def _times(n=500, start="2023-12-31T20:00:00", step_s=97):
    return (np.datetime64(start, "ns")
            + np.arange(n) * np.timedelta64(step_s, "s"))


@pytest.mark.parametrize("correct_minor", [False, True])
@pytest.mark.parametrize("subset", [None, ("M2", "K1", "Mf", "M4")])
def test_predict_tide_matches_jax(correct_minor, subset):
    cons = dict(MAJORS)
    cons.update({"Mf": (0.01, 10.0), "M4": (0.05, 300.0)})
    if subset:
        cons = {k: cons[k] for k in subset}
    t = _times()
    got = tide.predict_tide(t, cons, mean_level=0.3,
                            correct_minor=correct_minor)
    want = jtide.predict_tide(t, cons, mean_level=0.3,
                              correct_minor=correct_minor)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_predict_tide_scalar_time_and_unknown_name():
    t = np.datetime64("2024-03-01T06:30:00", "ns")
    np.testing.assert_allclose(tide.predict_tide(t, MAJORS),
                               jtide.predict_tide(t, MAJORS), atol=TOL)
    with pytest.raises(ValueError, match="unknown constituent"):
        tide.predict_tide(t, {"XX9": (1.0, 0.0)})


def test_tide_table_matches_jax():
    got = tide.tide_table("2023-05-01", "2023-05-02", MAJORS, freq="900s")
    want = jtide.tide_table("2023-05-01", "2023-05-02", MAJORS, freq="900s")
    pd.testing.assert_frame_equal(got, want, rtol=0, atol=TOL)


def _atlas_grids():
    rng = np.random.default_rng(3)
    lat = np.linspace(53.0, 55.0, 6)
    lon = np.linspace(7.0, 10.0, 7)
    cons = {}
    for k, name in enumerate(("M2", "S2", "K1", "O1", "N2")):
        amp = 0.2 + rng.uniform(size=(6, 7)) / (k + 1)
        ph = rng.uniform(-180, 540, size=(6, 7))
        cons[name] = (amp, ph)
    cons["M2"][0][3, 3] = np.nan  # a land node
    return lat, lon, cons


@pytest.mark.parametrize("constituents", [None, ["m2", "K1"]])
@pytest.mark.parametrize("correct_minor", [False, True])
def test_atlas_predict_matches_jax(constituents, correct_minor):
    lat, lon, cons = _atlas_grids()
    a, ja = tide.TideAtlas(lat, lon, cons), jtide.TideAtlas(lat, lon, cons)
    rng = np.random.default_rng(4)
    n = 300
    qlat = rng.uniform(52.5, 55.5, n)  # some beyond the rim: clamped
    qlon = rng.uniform(6.5, 10.5, n)
    t = _times(n)
    got = a.predict(t, qlat, qlon, constituents=constituents,
                    correct_minor=correct_minor)
    want = ja.predict(t, qlat, qlon, constituents=constituents,
                      correct_minor=correct_minor)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_atlas_errors_match_jax():
    lat, lon, cons = _atlas_grids()
    with pytest.raises(ValueError, match="strictly increasing"):
        tide.TideAtlas(lat[::-1], lon, cons)
    with pytest.raises(ValueError, match="unknown constituent"):
        tide.TideAtlas(lat, lon, {"ZZ": cons["M2"]})
    a = tide.TideAtlas(lat, lon, cons)
    with pytest.raises(ValueError, match="not in atlas"):
        a.predict(_times(3), [54.0] * 3, [8.0] * 3, constituents=["M4"])
    land = {"M2": (np.full((6, 7), np.nan), np.zeros((6, 7)))}
    with pytest.raises(ValueError, match="invalid"):
        tide.TideAtlas(lat, lon, land).predict(_times(1), [54.0], [8.0])


def test_atlas_file_round_trip_both_ways(tmp_path):
    """An atlas saved by either package loads in the other and predicts
    the same heights (h5py, through each package's ncio)."""
    pytest.importorskip("h5py")
    lat, lon, cons = _atlas_grids()
    p_port, p_jax = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    tide.TideAtlas(lat, lon, cons).save(p_port)
    jtide.TideAtlas(lat, lon, cons).save(p_jax)
    t = _times(50)
    q = (np.full(50, 54.1), np.full(50, 8.3))
    want = jtide.TideAtlas.from_file(p_jax).predict(t, *q)
    for path in (p_port, p_jax):
        got = tide.TideAtlas.from_file(path).predict(t, *q)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(jtide.TideAtlas.from_file(p_port).predict(t, *q),
                               want, rtol=0, atol=TOL)


def test_read_tide_csv_matches_pandas(tmp_path):
    """The numpy reader gives what the JAX step takes from pandas: ns
    times sorted as sort_values sorts them, and float heights: exactly
    the values written (``float`` rounds a 17-digit decimal correctly),
    and to 1e-15 m of pandas's (its C parser lands some values a few
    units in the last place off)."""
    p = str(tmp_path / "tide.csv")
    rng = np.random.default_rng(5)
    times = pd.date_range("2023-12-31T22:00:00", periods=40, freq="7min")
    heights = rng.normal(size=40)
    order = rng.permutation(40)
    pd.DataFrame({"height": heights[order],
                  "datetime": times[order]}).to_csv(p, index=False)
    t, h = tide.read_tide_csv(p)
    df = pd.read_csv(p, parse_dates=["datetime"]).sort_values("datetime")
    np.testing.assert_array_equal(
        t.astype(np.int64),
        df["datetime"].to_numpy().astype("datetime64[ns]").astype(np.int64))
    np.testing.assert_array_equal(h, heights)
    np.testing.assert_allclose(h, df["height"].to_numpy(float), rtol=0,
                               atol=1e-15)
    # the ISO 'T' form parses as well
    p2 = str(tmp_path / "iso.csv")
    with open(p2, "w") as fh:
        fh.write("datetime,height\n2023-05-01T09:00:00,0.5\n"
                 "2023-05-01T08:00:00.5,-0.5\n")
    t2, h2 = tide.read_tide_csv(p2)
    assert t2[0] == np.datetime64("2023-05-01T08:00:00.5")
    np.testing.assert_array_equal(h2, [-0.5, 0.5])


@pytest.mark.parametrize("stamp", ["05/01/2023 09:00", "2023-05-01 09:00+02:00",
                                   "1 May 2023"])
def test_read_tide_csv_names_the_format_it_refuses(tmp_path, stamp):
    p = str(tmp_path / "tide.csv")
    with open(p, "w") as fh:
        fh.write(f'datetime,height\n"{stamp}",0.1\n')
    with pytest.raises(ValueError, match="ISO 8601"):
        tide.read_tide_csv(p)


def test_read_tide_csv_needs_its_columns(tmp_path):
    p = str(tmp_path / "tide.csv")
    with open(p, "w") as fh:
        fh.write("time,h\n2023-05-01T09:00:00,0.1\n")
    with pytest.raises(ValueError, match="columns"):
        tide.read_tide_csv(p)
