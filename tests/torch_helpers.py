"""Helpers shared by the port's tests (imports no JAX: the card tests run
where there is none)."""

import numpy as np

# a relative gap this wide is far above the float32 rounding of either
# implementation (about 1e-6 of a slice's largest coefficient)
MIN_GAP = 1e-4


def gap_taus(mags: np.ndarray) -> np.ndarray:
    """(B, L, N) coefficient magnitudes -> (B, L) float32 thresholds, each
    in the widest relative gap between neighbouring magnitudes from the
    80th to the 95th percentile. No coefficient then lies within float32
    rounding of its threshold, so a hard threshold keeps the same
    coefficients however the arithmetic is ordered, and two
    implementations can be held to the soft thresholds' elementwise
    bound. A band without such a gap (one whose magnitudes are all equal,
    as the lowpass band of a box holding only the zero frequency) gets
    half its smallest magnitude: it keeps every coefficient."""
    out = np.empty(mags.shape[:2], np.float32)
    for idx in np.ndindex(*mags.shape[:2]):
        m = np.sort(mags[idx])
        seg = m[int(0.8 * m.size):int(0.95 * m.size)]
        with np.errstate(divide="ignore", invalid="ignore"):
            gaps = np.nan_to_num((seg[1:] - seg[:-1]) / seg[1:])
        k = int(np.argmax(gaps))
        out[idx] = (np.sqrt(seg[k] * seg[k + 1]) if gaps[k] > MIN_GAP
                    else 0.5 * m[0])
    return out


class MemoryCube:
    """An in-memory cube with ``CubeFile``'s slab methods and
    ``CubeWriter``'s: the source and the sink of the port's streamed
    passes (``preprocess_slabs``, ``postprocess_slabs``) without files.
    The arrays stay numpy on the host, where the files would be; a slab
    read is a copy, as a file read is. ``bytes_read`` and
    ``bytes_written`` count the slabs' bytes."""

    def __init__(self, coords, attrs=None, coord_attrs=None):
        self.bytes_read = self.bytes_written = 0
        self.coords = {k: np.asarray(v) for k, v in coords.items()}
        self.attrs = dict(attrs or {})
        self.coord_attrs = {k: dict(v) for k, v in (coord_attrs or {}).items()}
        self.data_vars = {}  # name -> dims, as CubeFile's
        self.var_attrs = {}
        self.arrays = {}

    @classmethod
    def from_cube(cls, cube):
        """A port ``Cube`` as a source (its arrays shared, not copied)."""
        mem = cls(cube.coords, cube.attrs, cube.coord_attrs)
        for name, (dims, data) in cube.data_vars.items():
            mem.data_vars[name] = tuple(dims)
            mem.arrays[name] = np.asarray(data)
            mem.var_attrs[name] = dict(cube.var_attrs.get(name, {}))
        return mem

    def dims_of(self, var):
        return self.data_vars[var]

    def primary_var(self):
        from pseudo_3d_interpolation_torch.io.cube import primary_var_name

        return primary_var_name(self.data_vars)

    def sizes(self):
        return {d: len(c) for d, c in self.coords.items()}

    def is_complex(self, var):
        return np.iscomplexobj(self.arrays[var])

    def dtype_of(self, var):
        return self.arrays[var].dtype

    def _sel(self, var, dim, start, stop):
        return tuple(slice(start, stop) if d == dim else slice(None)
                     for d in self.data_vars[var])

    def read_slab(self, var, dim=None, start=0, stop=None):
        out = np.array(self.arrays[var][self._sel(var, dim, start, stop)])
        self.bytes_read += out.nbytes
        return out

    def read(self, var):
        return self.read_slab(var)

    def create_var(self, name, dims, dtype, chunks=None, attrs=None):
        shape = tuple(len(self.coords[d]) for d in dims)
        self.data_vars[name] = tuple(dims)
        self.arrays[name] = np.empty(shape, dtype)
        self.var_attrs[name] = dict(attrs or {})

    def write_slab(self, name, data, dim=None, start=0):
        data = np.asarray(data)
        self.bytes_written += data.nbytes
        n = data.shape[self.data_vars[name].index(dim)] if dim else None
        self.arrays[name][self._sel(name, dim, start,
                                    None if n is None else start + n)] = data

    def set_attrs(self, **kw):
        self.attrs.update(kw)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def to_cube(self):
        from pseudo_3d_interpolation_torch.io.cube import Cube

        return Cube(coords=dict(self.coords),
                    data_vars={k: (d, self.arrays[k])
                               for k, d in self.data_vars.items()},
                    attrs=dict(self.attrs),
                    var_attrs={k: dict(v) for k, v in self.var_attrs.items()},
                    coord_attrs={k: dict(v)
                                 for k, v in self.coord_attrs.items()})


class MemoryStore:
    """The streamed passes' store in memory: each writer a new
    :class:`MemoryCube`, read back as itself; ``final`` is the last final
    writer, ``cubes`` every writer."""

    def __init__(self):
        self.final = None
        self.cubes = []

    def writer(self, coords, attrs=None, coord_attrs=None, final=True):
        w = MemoryCube(coords, attrs, coord_attrs)
        self.cubes.append(w)
        if final:
            self.final = w
        return w

    def reader(self, writer):
        return writer

    def bytes_moved(self) -> int:
        """Bytes written to and read from the store's cubes."""
        return sum(c.bytes_read + c.bytes_written for c in self.cubes)


# ---------------------------------------------------------------------------
# stage-1 surveys: SEG-Y profiles with the defects steps 01-08 repair
# ---------------------------------------------------------------------------
def ricker(t, f0=200.0):
    a = (np.pi * f0 * t) ** 2
    return (1 - 2 * a) * np.exp(-a)


def time_headers(times_start, ntr, step_s=1):
    """Recording-time header columns of ``ntr`` traces ``step_s`` seconds
    apart from ``times_start``."""
    t = (np.datetime64(times_start, "s")
         + np.arange(ntr) * np.timedelta64(step_s, "s"))
    year = t.astype("datetime64[Y]")
    day = t.astype("datetime64[D]")
    sod = (t - day.astype("datetime64[s]")).astype(np.int64)
    return {
        "YearDataRecorded": year.astype(np.int64) + 1970,
        "DayOfYear": (day - year.astype("datetime64[D]")).astype(np.int64) + 1,
        "HourOfDay": sod // 3600,
        "MinuteOfHour": (sod % 3600) // 60,
        "SecondOfMinute": sod % 60,
    }


def make_profile(path, ntr=80, ns=400, dt_us=250, delrt_ms=20,
                 seafloor_ms=None, seed=0, times_start="2023-05-01T10:00:00",
                 x0=0.0, y0=0.0, heading=(1.0, 0.0), spacing=5.0,
                 extra_headers=None, data=None, spikes=(), scalar=-100,
                 noise=0.02):
    """Write a profile: a Ricker seafloor at ``seafloor_ms`` absolute TWT
    recorded from ``delrt_ms`` on N(0, ``noise``) noise (or ``data``), with
    ``spikes`` ((trace, sample, value) triples), one trace a second from
    ``times_start``, coordinates stored with ``scalar``, or in degrees as
    milli-arc-seconds (CoordinateUnits 2) with ``scalar='mas'``. Returns
    the samples written."""
    from pseudo_3d_interpolation_torch.io.segy import write_segy

    rng = np.random.default_rng(seed)
    dt_ms = dt_us / 1000.0
    delay = np.broadcast_to(np.asarray(delrt_ms, np.float64), (ntr,))
    if data is None:
        data = rng.normal(0, noise, (ntr, ns)).astype(np.float32)
        if seafloor_ms is None:
            seafloor_ms = np.full(ntr, 40.0)
        t_axis = np.arange(ns) * dt_ms
        rel = np.asarray(seafloor_ms, np.float64) - delay
        data += ricker((t_axis[None, :] - rel[:, None]) * 1e-3
                       ).astype(np.float32)
    data = np.array(data, np.float32)
    for tr, s, v in spikes:
        data[tr, s] = v
    xs = x0 + np.arange(ntr) * spacing * heading[0]
    ys = y0 + np.arange(ntr) * spacing * heading[1]
    if scalar == "mas":
        f, scalar, units = 3.6e6, -1000, 2
    else:
        f, units = (-scalar if scalar < 0 else 1.0 / scalar), 1
    headers = {
        "SourceX": np.rint(xs * f).astype(np.int64),
        "SourceY": np.rint(ys * f).astype(np.int64),
        "SourceGroupScalar": scalar,
        "CoordinateUnits": units,
        "DelayRecordingTime": (np.asarray(delrt_ms) if np.ndim(delrt_ms)
                               else delrt_ms),
        **time_headers(times_start, ntr),
    }
    headers.update(extra_headers or {})
    write_segy(path, data, headers=headers, fmt=5, dt_us=dt_us)
    return data


def write_tide_csv(path, start, n, step_s, heights):
    """A tide series CSV (``datetime``, ``height``) as pandas writes one."""
    times = (np.datetime64(start, "s")
             + np.arange(n) * np.timedelta64(step_s, "s"))
    with open(path, "w") as fh:
        fh.write("datetime,height\n")
        for t, h in zip(times, heights):
            fh.write(f"{str(t).replace('T', ' ')},{float(h)!r}\n")


def write_stage1_survey(d, n_lines=3, n_ties=1, ntr=120, ns=400, seed=0,
                        dt_us=250, n_small=20, gap=3):
    """Write a survey with every defect stage 1 repairs into directory
    ``d`` and return what was injected.

    ``n_lines`` parallel lines (west to east) and ``n_ties`` tie lines
    (south to north) crossing all of them, ``ntr`` traces of ``ns``
    samples each, in WGS84 degrees (about 11 m a trace), recorded one
    after another from 2023-12-31 20:00 (the survey crosses the new
    year). The seafloor is one surface over the area. Defects:

    - line 0 ends in a short file (``n_small`` traces) recorded after a
      gap of ``gap`` missing traces (step 01 merges it and fills the gap);
    - a run of 6 traces per parallel line with a zero delay in the header
      (recorded at 20 ms; step 03); the tie lines recorded from 15 ms;
    - heave jitter of -1..1 samples on every trace (step 05). The
      reference chain treats a larger jitter as noise in places: the
      pick's moving double-MAD filters re-interpolate picks 4 samples off
      their window's median (2-5 samples off the truth with -2..2), and
      the delrt correction re-bases a wrong-delay trace by its first
      break, jitter and all, when that lies over 1 ms from its
      neighbours' (a delay 1 ms off with -3..3); both packages do so
      alike, and the truth check below holds what the chain repairs;
    - a tide from ``tide.csv`` deepening the seafloor by 2h/1500 m/s
      (step 06), the seafloor then rounded to whole samples;
    - the last tie line recorded 1 ms deeper (step 07; with one tie line,
      parallel line ``n_lines // 2``): a tie's shift rests on one crossing
      a parallel line, each within about two samples after the statics
      and the tide's whole-sample shifts, so the line-wide offset is put
      where the network measures it from many;
    - 4 spikes of ±30 on every line, away from the crossings (step 08).

    Returns a dict: ``tide`` (the CSV path), ``lines`` (file stem ->
    dict of per-trace truth over the line's ``ntr`` positions:
    ``delrt`` (true delays), ``floor_ms`` (recorded seafloor TWT,
    defects included), ``jitter`` (samples), ``tide_ms``, ``valid``
    (False in the gap), ``spikes``), ``mistie_line`` and ``mistie_ms``.
    """
    from pathlib import Path

    d = Path(d)
    rng = np.random.default_rng(seed)
    dt_ms = dt_us / 1000.0
    lat0, lon0, dlat, dlon = 54.0, 8.9, 1e-4, 1.6e-4
    g = ntr // (n_lines + 1)  # tie traces between parallel lines
    x_tie = [(j + 1) * ntr // (n_ties + 1) for j in range(n_ties)]
    mistie_line = (f"T{n_ties - 1:02d}" if n_ties > 1
                   else f"L{n_lines // 2:02d}")
    mistie_ms = 1.0
    t_start = np.datetime64("2023-12-31T20:00:00", "s")
    n_total = n_lines + n_ties
    # the tide: an M2-like series every 10 minutes over the whole survey
    n_tide = int((n_total * (ntr + 60) + 7200) // 600)
    t_tide = t_start - np.timedelta64(3600, "s") \
        + np.arange(n_tide) * np.timedelta64(600, "s")
    h_tide = 0.8 * np.sin(2 * np.pi * np.arange(n_tide) * 600 / 44712.0)
    tide = str(d / "tide.csv")
    write_tide_csv(tide, str(t_tide[0]), n_tide, 600, h_tide)

    def surface(lat, lon):
        return (55.0 + 1.5 * np.sin(2 * np.pi * (lon - lon0) / (ntr * dlon))
                + 1.0 * np.cos(2 * np.pi * (lat - lat0) / (ntr * dlat)))

    truth = {"tide": tide, "lines": {}, "mistie_line": mistie_line,
             "mistie_ms": mistie_ms}
    for k in range(n_total):
        tie = k >= n_lines
        name = f"T{k - n_lines:02d}" if tie else f"L{k:02d}"
        idx = np.arange(ntr)
        if tie:
            lat = lat0 + idx * dlat
            lon = np.full(ntr, lon0 + x_tie[k - n_lines] * dlon)
            crossings = [(j + 1) * g for j in range(n_lines)]
        else:
            lat = np.full(ntr, lat0 + (k + 1) * g * dlat)
            lon = lon0 + idx * dlon
            crossings = x_tie
        start = t_start + np.timedelta64(k * (ntr + 60), "s")
        times = start + idx * np.timedelta64(1, "s")
        tide_m = np.interp(times.astype("datetime64[ns]").astype(np.int64),
                           t_tide.astype("datetime64[ns]").astype(np.int64),
                           h_tide)
        tide_ms = 2.0 * tide_m / 1500.0 * 1e3
        jitter = rng.integers(-1, 2, ntr)
        # on whole samples: a reflector midway between two samples is
        # picked on either, as the noise has it
        floor = dt_ms * (np.rint((surface(lat, lon) + tide_ms) / dt_ms)
                         + jitter) + (mistie_ms if name == truth["mistie_line"]
                                      else 0.0)
        delrt = np.full(ntr, 15 if tie else 20)
        header_delrt = delrt.copy()
        if not tie:
            w0 = int(rng.integers(ntr // 4, 3 * ntr // 4 - 6))
            header_delrt[w0: w0 + 6] = 0
        far = np.ones(ntr, bool)
        for c in crossings:
            far[max(c - 4, 0): c + 5] = False
        valid = np.ones(ntr, bool)
        cut = ntr
        if k == 0 and n_small:
            cut = ntr - n_small - gap
            valid[cut: cut + gap] = False
        far &= valid
        far[:8] = far[-8:] = False
        spike_tr = rng.choice(np.nonzero(far)[0], 4, replace=False)
        spike_s = rng.integers(ns // 2, ns - ns // 8, 4)
        spikes = [(int(t), int(s), float(v)) for t, s, v in
                  zip(spike_tr, spike_s, rng.choice([-30.0, 30.0], 4))]
        data = make_profile(str(d / "tmp.sgy"), ntr=ntr, ns=ns, dt_us=dt_us,
                            delrt_ms=delrt, seafloor_ms=floor,
                            seed=seed + 1 + k, spikes=spikes, noise=0.005)
        (d / "tmp.sgy").unlink()
        common = dict(ns=ns, dt_us=dt_us, scalar="mas")
        parts = [(name, np.arange(cut))]
        if cut < ntr:
            parts.append((name + "b", np.arange(cut + gap, ntr)))
        for stem, sel in parts:
            make_profile(str(d / f"{stem}_WGS84.sgy"), ntr=len(sel),
                         delrt_ms=header_delrt[sel], data=data[sel],
                         x0=lon[sel[0]], y0=lat[sel[0]],
                         heading=(0.0, 1.0) if tie else (1.0, 0.0),
                         spacing=dlat if tie else dlon,
                         times_start=str(times[sel[0]]), **common)
        truth["lines"][name] = dict(delrt=delrt, floor_ms=floor,
                                    jitter=jitter, tide_ms=tide_ms,
                                    valid=valid, spikes=spikes)
    return truth


STAGE1_STEPS = ("merge", "reproject", "delrt_correct", "delrt_pad",
                "static_correct", "tide_compensate", "mistie_correct",
                "despike")


def stage1_steps(stage1, tide, timings=None):
    """Steps 01-08 of ``stage1`` (either package's module) with the
    settings the survey of :func:`write_stage1_survey` needs, as
    ``(name, step, takes a device)``: ``step(files, **kw)`` maps its input
    files (or directory) to its outputs. ``timings`` goes to the mistie
    step (the port's only)."""
    mistie_kw = {} if timings is None else {"timings": timings}
    return [
        ("merge", lambda f, **kw: stage1.merge_small_files(
            f, min_kb=100.0, max_gap_s=60.0, **kw), False),
        ("reproject", lambda f, **kw: stage1.reproject(f, 4326, 32632, **kw),
         False),
        ("delrt_correct", lambda f, **kw: stage1.delrt_correct(
            f, win_samples=200, **kw), True),
        ("delrt_pad", lambda f, **kw: stage1.delrt_pad(f, **kw), False),
        ("static_correct", lambda f, **kw: stage1.static_correct(
            f, nsta=4, nlta=60, savgol_window=15, **kw), True),
        ("tide_compensate", lambda f, **kw: stage1.tide_compensate(
            f, tide, **kw), True),
        ("mistie_correct", lambda f, **kw: stage1.mistie_correct(
            f, min_correlation=0.5, **mistie_kw, **kw), True),
        ("despike", lambda f, **kw: stage1.despike(f, threshold=5.0, **kw),
         True),
    ]


def run_stage1(stage1, d, tide, **dev):
    """Steps 01-08 of ``stage1`` chained on the survey in directory ``d``
    (:func:`stage1_steps`); returns each step's output files by step
    name. ``dev`` (``device=...``) goes to the steps that take one."""
    outs, files = {}, str(d)
    for name, step, takes_device in stage1_steps(stage1, tide):
        files = outs[name] = step(files, **(dev if takes_device else {}))
    return outs


def stage1_pipeline_steps(tide):
    """The steps of :func:`stage1_steps` as a ``run_pipeline`` step list."""
    return [{"merge": {"min_kb": 100.0, "max_gap_s": 60.0}},
            {"reproject": {"src_epsg": 4326, "dst_epsg": 32632}},
            {"delrt-correct": {"win_samples": 200}},
            {"delrt-pad": {}},
            {"static": {"nsta": 4, "nlta": 60, "savgol_window": 15}},
            {"tide": {"tide_file": str(tide)}},
            {"mistie": {"min_correlation": 0.5}},
            {"despike": {"threshold": 5.0}}]


def stage1_cli_steps(tide):
    """:func:`stage1_pipeline_steps` as ``(subcommand, options)``: the
    same command lines for ``p3d`` and ``p3d-torch`` (each option
    ``--name value``, its key's underscores as dashes)."""
    return [(name, [a for k, v in opts.items()
                    for a in (f"--{k.replace('_', '-')}", str(v))])
            for step in stage1_pipeline_steps(tide)
            for name, opts in step.items()]


def run_stage1_cli(main, inputs, out_dir, tide, extra=(), walls=None):
    """Each subcommand of :func:`stage1_cli_steps` through ``main`` (either
    package's ``cli.main``) on ``inputs[k]``, what step k got in a chain of
    :func:`stage1_steps` (a directory, or files, passed as a datalist),
    writing into ``out_dir/NN_<subcommand>``; ``extra`` goes on every
    command line, ``walls`` (a dict) gets each command's seconds. Returns
    the output directories in step order."""
    import os
    import time

    dirs = []
    for k, ((cmd, opts), inp) in enumerate(zip(stage1_cli_steps(tide),
                                               inputs)):
        d = os.path.join(str(out_dir), f"{k + 1:02d}_{cmd}")
        os.makedirs(d)
        if not isinstance(inp, str):
            lst = d + ".txt"
            with open(lst, "w") as fh:
                fh.write("".join(os.path.abspath(p) + "\n" for p in inp))
            inp = lst
        t0 = time.perf_counter()
        rc = main([cmd, inp, "--output-dir", d, *opts, *extra])
        if walls is not None:
            walls[cmd] = time.perf_counter() - t0
        assert rc == 0, (cmd, rc)
        dirs.append(d)
    return dirs


def cli_step_outputs(outs, inputs, out_dir):
    """Where a subcommand writing into ``out_dir`` put each output of its
    step's function (``outs``, from ``inputs``): the file of that name in
    ``out_dir``, or, for a file merge left alone, the input itself.
    Asserts that ``out_dir`` holds no other SEG-Y file."""
    import glob
    import os

    if isinstance(inputs, str):
        inputs = glob.glob(os.path.join(inputs, "*.sgy"))
    keep = {os.path.abspath(p) for p in inputs}
    got = [p if os.path.abspath(p) in keep
           else os.path.join(out_dir, os.path.basename(p)) for p in outs]
    written = set(glob.glob(os.path.join(out_dir, "*.sgy")))
    assert written == {p for p in got if os.path.dirname(p) == out_dir}, \
        (sorted(written), got)
    return got


def same_bytes(got, want):
    """Assert two lists of files equal byte for byte, name by name."""
    import os

    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), (g, w)


def check_stage1_truth(truth, outs, dt_ms=0.25, savgol_window=15):
    """Hold the outputs of :func:`run_stage1` on a survey of
    :func:`write_stage1_survey` to what it injected; returns a dict of
    counts, raises AssertionError on the first miss:

    - the corrected delays (step 03) equal the recorded ones, exactly;
    - the seafloor picks of step 05 (``.sta`` ``horizon_sample``) lie
      within one sample of the injected seafloor on the padded axis (the
      reference picker truncates its cubic re-interpolation of the picks,
      ``astype(int)``, so a 105.99999 lands on 105), and
      each pick moved by its static within one sample of the smoothed
      injected seafloor (``savgol`` of the injected picks, the surface
      the static flattens the jitter onto), away from line 0's gap;
    - the tide shifts (``.tid``) equal ``-rint(tide TWT / dt)``;
    - the mistie line's shift (``.mst``) less the mean of the other
      lines of its kind (tie or parallel) is ``-mistie_ms`` within one
      sample;
    - every injected spike reaches the despike step (|x| >= 20 there) and
      leaves it below 1.
    """
    import os

    import scipy.signal

    from pseudo_3d_interpolation_torch.io.auxiliary import read_csv_columns
    from pseudo_3d_interpolation_torch.io.segy import SegyFile

    def line_of(path):
        return os.path.basename(path)[:3]

    def sidecar(path, suffix):
        return read_csv_columns(os.path.splitext(path)[0] + suffix)

    lines = truth["lines"]
    counts = {"delays": 0, "picks": 0, "statics": 0, "tide": 0,
              "spikes": 0}
    for p in outs["delrt_correct"]:
        t = lines[line_of(p)]
        with SegyFile(p) as f:
            got = f.header("DelayRecordingTime")
        bad = np.nonzero(got != t["delrt"])[0]
        assert not bad.size, (p, bad[:8], got[bad[:8]])
        counts["delays"] += got.size
    with SegyFile(outs["delrt_pad"][0]) as f:
        pad0 = float(f.header("DelayRecordingTime")[0])
    for p in outs["static_correct"]:
        t = lines[line_of(p)]
        sta = sidecar(p, ".sta")
        pick = np.rint((t["floor_ms"] - pad0) / dt_ms)
        ok = t["valid"].copy()
        gap = np.nonzero(~ok)[0]
        if gap.size:
            ok[max(gap[0] - savgol_window, 0): gap[-1] + savgol_window] = False
        d_pick = np.abs(sta["horizon_sample"] - pick)[ok]
        assert d_pick.max() <= 1, (p, int(d_pick.max()))
        smooth = np.rint(scipy.signal.savgol_filter(pick, savgol_window, 1))
        d_sta = np.abs(sta["horizon_sample"] + sta["static_samples"]
                       - smooth)[ok]
        assert d_sta.max() <= 1, (p, float(d_sta.max()))
        counts["picks"] += int(ok.sum())
        counts["statics"] += int(ok.sum())
    for p in outs["tide_compensate"]:
        t = lines[line_of(p)]
        tid = sidecar(p, ".tid")
        want = -np.rint(t["tide_ms"] / dt_ms)
        ok = t["valid"]
        np.testing.assert_array_equal(tid["shift_samples"][ok], want[ok])
        counts["tide"] += int(ok.sum())
    shifts = {line_of(p): float(sidecar(p, ".mst")["shift_ms"][0])
              for p in outs["mistie_correct"]}
    others = [v for k, v in shifts.items()
              if k[0] == truth["mistie_line"][0] and k != truth["mistie_line"]]
    rel = shifts[truth["mistie_line"]] - float(np.mean(others))
    assert abs(rel + truth["mistie_ms"]) <= dt_ms, (rel, truth["mistie_ms"])
    counts["mistie_ms"] = rel
    for p_in, p_out in zip(outs["mistie_correct"], outs["despike"]):
        t = lines[line_of(p_in)]
        with SegyFile(p_in) as a, SegyFile(p_out) as b:
            x, y = a.trace_data(), b.trace_data()
        hits = np.argwhere(np.abs(x) >= 20)
        assert len(hits) == len(t["spikes"]), (p_in, len(hits))
        assert np.abs(y[hits[:, 0], hits[:, 1]]).max() < 1.0
        counts["spikes"] += len(hits)
    return counts


def same_segy(got, want, exact=True):
    """Assert two SEG-Y files equal: textual, binary and trace headers
    byte for byte; samples bit for bit, or with ``exact=False`` within
    1e-6 of the largest |sample|."""
    from pseudo_3d_interpolation_torch.io.segy import SegyFile

    with SegyFile(got) as g, SegyFile(want) as w:
        assert g.text_raw == w.text_raw, (got, "textual header")
        np.testing.assert_array_equal(g.binary_header_raw(),
                                      w.binary_header_raw())
        np.testing.assert_array_equal(g.trace_headers_raw(),
                                      w.trace_headers_raw())
        dg, dw = g.trace_data(), w.trace_data()
    if exact:
        np.testing.assert_array_equal(dg, dw)
    else:
        np.testing.assert_allclose(dg, dw, rtol=0,
                                   atol=1e-6 * np.abs(dw).max())


def _by_name(col):
    import os

    if col.dtype.kind in "OU":  # paths: compared by their file names
        return np.array([os.path.basename(str(v)) for v in col], object)
    return col


def same_csv(got, want, atol=None):
    """Assert two sidecar CSVs equal as parsed numbers, column by column
    (``atol``: column -> absolute tolerance), paths by file name."""
    from pseudo_3d_interpolation_torch.io.auxiliary import read_csv_columns

    g, w = read_csv_columns(got), read_csv_columns(want)
    assert list(g) == list(w), (got, list(g), list(w))
    for k in w:
        a, b = _by_name(g[k]), _by_name(w[k])
        if atol and k in atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol[k])
        else:
            np.testing.assert_array_equal(a, b)


def same_outputs(got, want, exact=True, sidecars=(), atol=None):
    """Assert two lists of step outputs equal file by file
    (:func:`same_segy`), with their ``sidecars`` (:func:`same_csv`)."""
    import os

    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        same_segy(g, w, exact=exact)
        for suffix in sidecars:
            gp, wp = (os.path.splitext(p)[0] + suffix for p in (g, w))
            assert os.path.exists(gp) == os.path.exists(wp), gp
            if os.path.exists(wp):
                same_csv(gp, wp, atol)
