"""End-to-end demo of the PyTorch port: a synthetic multi-line survey ->
the whole workflow -> QC images.

The counterpart of ``examples/demo_synthetic_survey.py`` on
``pseudo_3d_interpolation_torch``: it makes a decimated pseudo-3D survey
with injected defects (spikes, heave jitter), written as IBM-float SEG-Y
like real TOPAS data, and runs stage 1 (despike, static correction),
binning, stage 2 (preprocess, forward FFT, POCS on every frequency slice,
inverse FFT, postprocess), the SEG-Y export and the QC plots through the
library API. Cubes stay in memory (no netCDF files, so no h5py); pandas is
not needed. The QC plots need matplotlib: where it is not installed (as on
a card's machine) they are skipped with a line saying so.

Run:  python examples/demo_synthetic_survey_torch.py [output_dir]
          [--device cpu|cuda] [--lines N] [--traces N] [--samples N]
          [--niter N]
(on a CUDA card by default; ``--device cpu`` runs the plain PyTorch
versions on the host.)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _times(hour: int, ntr: int):
    """Header date fields of ``ntr`` traces one second apart from
    2023-06-01 ``hour``:00:00, as numpy arrays."""
    t = (np.datetime64(f"2023-06-01T{hour:02d}:00:00")
         + np.arange(ntr).astype("timedelta64[s]"))
    day = t.astype("datetime64[D]")
    secs = (t - day).astype(np.int64)
    doy = (day - np.datetime64("2023-01-01")).astype(np.int64) + 1
    return {"YearDataRecorded": np.full(ntr, 2023), "DayOfYear": doy,
            "HourOfDay": secs // 3600, "MinuteOfHour": secs // 60 % 60,
            "SecondOfMinute": secs % 60}


def make_survey(survey_dir: str, n_lines=24, ntr=48, ns=384, dt_us=250,
                spacing=10.0, keep_frac=0.6, seed=0):
    """Write the acquired lines of a synthetic survey; returns the truth
    (n_lines, ntr, ns), the acquired line indices and the seafloor's
    depth function."""
    from pseudo_3d_interpolation_torch.io.segy import write_segy

    rng = np.random.default_rng(seed)
    acquired = sorted(set([0, n_lines - 1]) | {
        int(i) for i in rng.choice(n_lines, size=int(n_lines * keep_frac),
                                   replace=False)})
    dt_ms = dt_us / 1000.0
    t_axis = np.arange(ns) * dt_ms

    def ricker(t, f0=250.0):
        a = (np.pi * f0 * t) ** 2
        return (1 - 2 * a) * np.exp(-a)

    def floor_of(i, j):
        return 40.0 + 2.5 * np.sin(0.25 * i) + 1.5 * np.cos(0.2 * j)

    truth = np.zeros((n_lines, ntr, ns), np.float32)
    for i in range(n_lines):
        for j in range(ntr):
            for horizon, amp in [(floor_of(i, j), 1.0),
                                 (floor_of(i, j) + 25.0, -0.5)]:
                truth[i, j] += amp * ricker(
                    (t_axis - (horizon - 20.0)) * 1e-3).astype(np.float32)

    for i in acquired:
        data = truth[i] + rng.normal(0, 0.02, (ntr, ns)).astype(np.float32)
        jitter = rng.integers(-3, 4, ntr)
        for j in range(ntr):
            data[j] = np.roll(data[j], jitter[j])
        if i == acquired[1]:  # plant spikes in one line
            data[5, min(100, ns - 1)] = 25.0
            data[min(20, ntr - 1), min(200, ns - 3):min(203, ns)] = -20.0
        write_segy(
            os.path.join(survey_dir, f"line{i:02d}_UTM.sgy"), data,
            headers={
                "SourceX": np.rint((5.0 + i * spacing) * 100).astype(np.int64),
                "SourceY": np.rint((5.0 + np.arange(ntr) * spacing)
                                   * 100).astype(np.int64),
                "SourceGroupScalar": -100, "CoordinateUnits": 1,
                "DelayRecordingTime": 20,
                **_times(6 + i % 18, ntr),
            },
            fmt=1, dt_us=dt_us,  # IBM float, like real TOPAS data
        )
    return truth, np.asarray(acquired), floor_of


def main(out_root="demo_output", device=None, n_lines=24, ntr=48, ns=384,
         niter=50) -> dict:
    """Run the demo; returns the artifacts' paths and the figures made
    (an empty list without matplotlib)."""
    from pseudo_3d_interpolation_torch import backends, qc
    from pseudo_3d_interpolation_torch.io.segy import SegyFile
    from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
    from pseudo_3d_interpolation_torch.ops import metrics
    from pseudo_3d_interpolation_torch.pipeline import stage1
    from pseudo_3d_interpolation_torch.pipeline.binning import (
        BinningGeometry, bin_cube)
    from pseudo_3d_interpolation_torch.pipeline.export import cube_to_segy
    from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
    from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate
    from pseudo_3d_interpolation_torch.pipeline.postprocess import postprocess
    from pseudo_3d_interpolation_torch.pipeline.preprocess import preprocess

    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    figures = []

    def plot(fn, *args, path, **kwargs):
        if plots:
            fn(*args, path=path, **kwargs)
            figures.append(path)

    os.makedirs(out_root, exist_ok=True)
    survey = os.path.join(out_root, "survey")
    os.makedirs(survey, exist_ok=True)
    spacing = 10.0
    print(f"backends: {backends.summary()}")
    if not plots:
        print("matplotlib is not installed: the QC plots are skipped")
    print("1/7 creating synthetic survey (IBM-float SEG-Y)...")
    truth, acquired, _ = make_survey(survey, n_lines, ntr, ns)
    print(f"    {len(acquired)}/{n_lines} lines acquired")

    print("2/7 stage 1: despike + static correction...")
    work = os.path.join(out_root, "work")
    outs = stage1.despike(survey, threshold=6.0, output_dir=work,
                          device=device)
    outs = stage1.static_correct(work, savgol_window=21, inplace=True,
                                 device=device)

    with SegyFile(outs[0]) as f:
        plot(qc.plot_seismic_image, f.trace_data().T,
             title="first profile after stage 1",
             path=os.path.join(out_root, "qc_profile.png"))

    print("3/7 binning onto the 3D grid...")
    geom = BinningGeometry(spacing=spacing,
                           extent=(0.0, n_lines * spacing, 0.0, ntr * spacing))
    cube = bin_cube(outs, geom, device=device)
    plot(qc.plot_fold_map, cube["fold"],
         path=os.path.join(out_root, "qc_fold.png"))

    print("4/7 preprocess + forward FFT...")
    pp = preprocess(cube, balance="rms", device=device)
    freq = apply_fft(pp, device=device)

    print("5/7 POCS interpolation of every frequency slice...")
    cfg = POCSConfig(niter=niter, thresh_op="hard", p_min="adaptive",
                     version="fast", alpha=0.75, eps=1e-16)
    interp = interpolate(freq, cfg, batch=32,
                         runtime_csv=os.path.join(out_root, "runtimes.csv"),
                         device=device)

    print("6/7 inverse FFT + postprocess...")
    back = apply_ifft(interp, var="freq_amp_interp", device=device)
    out_var = next(v for v in back.data_vars if v not in ("fold", "amp_ref"))
    post = postprocess(back, var=out_var,
                       smoothing={"kind": "gaussian", "sigma": 0.8},
                       device=device)

    rec = np.asarray(post[out_var])
    missing = np.setdiff1d(np.arange(n_lines), acquired)
    amp = np.asarray(pp["amp"])
    sign_snr = float(metrics.snr(np.sign(truth), np.sign(amp), device="cpu"))
    print(f"    cube SNR (vs amp-normalized truth): sparse {sign_snr:.1f} -> "
          "see QC images")
    j = ntr // 2
    plot(qc.plot_seismic_difference, amp[:, j, :].T, rec[:, j, :].T,
         titles=("binned (gaps)", "interpolated"),
         path=os.path.join(out_root, "qc_interpolation.png"))

    print("7/7 exporting final SEG-Y...")
    post.data_vars["fold"] = cube.data_vars["fold"]
    final = cube_to_segy(post, os.path.join(out_root, "cube_final.sgy"),
                         var=out_var)
    print(f"done — artifacts in {out_root}/")
    print(f"    missing lines reconstructed: {missing.tolist()}")
    return {"segy": final, "figures": figures, "runtimes":
            os.path.join(out_root, "runtimes.csv"), "cube": post,
            "var": out_var, "sign_snr": sign_snr}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_root", nargs="?", default="demo_output")
    parser.add_argument("--device", default=None,
                        help="'cpu' or 'cuda' (default: the first card)")
    parser.add_argument("--lines", type=int, default=24)
    parser.add_argument("--traces", type=int, default=48)
    parser.add_argument("--samples", type=int, default=384)
    parser.add_argument("--niter", type=int, default=50)
    a = parser.parse_args()
    main(a.out_root, a.device, a.lines, a.traces, a.samples, a.niter)
