"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the repository root:

    python3 chip_smoke.py [--trace DIR]

Phases, each of which exits non-zero on failure:
1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles the CUDA sources of ``pseudo_3d_interpolation_torch``
   with nvcc for sm_90a and prints the time;
3. kernel against plain: the ``pocs_solve`` kernel against its plain
   PyTorch version on the card: at 512² (batch 8, 10 iterations, regular
   and fast, soft and hard thresholds), one 384x512 rectangle, and at the
   shapes the main path gives the kernel (batch 32 and the cube's last
   batch of 1, 50 iterations, hard/fast at 'high'); times both at batch 32;
4. main path: ``pipeline.pocs.interpolate`` with its production defaults
   on an in-memory 512x512 frequency cube of 513 slices (the north star's
   rfft slice count), stored (iline, xline, freq) as users store it, of
   plane waves under a 50% column mask; asserts that the kernel ran once
   per batch, that the output is finite and that it is closer to the truth
   than the masked input.

``--trace DIR`` runs the main path once more under ``torch.profiler``,
writes the Chrome trace to ``DIR/main_path_trace.json`` and prints the
device's busy time (the union of kernel, memcpy and memset intervals),
its idle share of the traced wall time, and the largest device and host
entries.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists each kernel with its launch count, error and
times.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

SOURCE = "pseudo_3d_interpolation_torch/csrc/pocs_solve.cu"
REPLACES = "pseudo_3d_interpolation_tpu/ops/pallas/pocs_iter.py:774"
# soft thresholds: dense fp32 DFT products against cuFFT differ by rounding
SOFT_TOL = 1e-4
# hard thresholds flip coefficients at the threshold under reordered
# arithmetic, so kernel and plain are compared by SNR against the truth;
# after 50 iterations both reach the float32 rounding floor against the
# truth, where the SNRs' difference measures rounding alone: there the
# elementwise bound SOFT_TOL also passes the case
SNR_TOL_DB = 0.1
# the cost is (d/s)² with d a small difference of two float32 slice sums:
# sqrt(cost) carries their rounding directly
SQRT_COST_ATOL = 1e-6
N = 512
SLICES = 513  # rfft bins of a 1024-sample trace (BASELINE.md:24)
MAIN_BATCH = 32  # the resident driver's batch (pipeline/pocs.py)
NITER = 50  # the production default
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def plane_waves(torch, f, h, w, seed, device):
    """(f, h, w) complex64 truth of six on-bin plane waves per slice (the
    construction of bench.py:113-122) and a 50% column mask, made from
    ``seed``."""
    rng = np.random.default_rng(seed)
    fy = torch.as_tensor(rng.integers(1, 24, size=(f, 6)), device=device)
    fx = torch.as_tensor(rng.integers(1, 24, size=(f, 6)), device=device)
    amp = torch.as_tensor(rng.uniform(0.5, 2.0, size=(f, 6)), device=device)
    ph = torch.as_tensor(rng.uniform(0, 6.28, size=(f, 6)), device=device)
    iy = torch.arange(h, device=device, dtype=torch.int64)[None, :, None]
    ix = torch.arange(w, device=device, dtype=torch.int64)[None, None, :]
    truth = torch.zeros((f, h, w), dtype=torch.complex64, device=device)
    for k in range(6):
        # exact integer phase index modulo one period, then float64 angle
        fyk, fxk = fy[:, k, None, None], fx[:, k, None, None]
        idx = (fyk * iy * w + fxk * ix * h) % (h * w)
        ang = (2 * math.pi * idx.to(torch.float64) / (h * w)
               + ph[:, k, None, None])
        truth += (amp[:, k, None, None]
                  * torch.exp(1j * ang)).to(torch.complex64)
        del idx, ang
    cols = torch.as_tensor(rng.uniform(size=w) < 0.5, device=device)
    mask = cols[None, :].expand(h, w).to(torch.float32).contiguous()
    return truth, mask


def snr_db(torch, ref, x) -> float:
    """10·log10(Σ|ref|² / Σ|ref − x|²), as ops/metrics.py::snr, summed in
    float64 on the tensors' device."""
    num = torch.sum(torch.abs(ref).double() ** 2)
    den = torch.sum(torch.abs(ref - x).double() ** 2)
    return float(10 * torch.log10(num / den))


def decay_for(torch, obs, niter):
    """The exponential schedule the solver derives (p_max 0.99, adaptive
    p_min) for a batch of observed slices."""
    from pseudo_3d_interpolation_torch.ops import decay, dft

    return decay.threshold_decay(dft.fft2(obs).abs(), "exponential", niter,
                                 p_max=0.99, p_min="adaptive").contiguous()


def time_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_against_plain(torch, ks, Cplx, case, seed, dev):
    """Run kernel and plain on one case, check them, print the comparison.
    Returns the inputs and max|Δ|."""
    b, h, w, op, ver, niter, precision = case
    truth, mask = plane_waves(torch, b, h, w, seed, dev)
    obs = truth * mask
    z = Cplx(obs.real.contiguous(), obs.imag.contiguous())
    tau = decay_for(torch, z, niter)
    res, cost = ks.pocs_solve(z, mask, tau, 0.75, op, ver, precision)
    ref, ref_cost = ks.pocs_solve_plain(z, mask, tau, 0.75, op, ver)
    got = torch.complex(res.re, res.im)
    want = torch.complex(ref.re, ref.im)
    label = f"{b}x{h}x{w} {op}/{ver} niter {niter} '{precision}'"
    if not bool(torch.isfinite(got).all()):
        fail(f"kernel output not finite at {label}")
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    s_k, s_p = snr_db(torch, truth, got), snr_db(torch, truth, want)
    print(f"kernel vs plain {label}: max|d|={err:.3e} ({err / scale:.2e} of "
          f"max), SNR kernel {s_k:.3f} dB, plain {s_p:.3f} dB", flush=True)
    if op == "soft":
        if err > SOFT_TOL * scale:
            fail(f"soft {label}: max|d| {err:.3e} > {SOFT_TOL} of "
                 f"max|plain| {scale:.3e}")
        c_err = float(torch.max(torch.abs(torch.sqrt(cost)
                                          - torch.sqrt(ref_cost))))
        if c_err > SQRT_COST_ATOL:
            fail(f"soft {label}: sqrt(final cost) differs by {c_err:.2e}")
    elif abs(s_k - s_p) > SNR_TOL_DB and not (
            niter == NITER and err <= SOFT_TOL * scale):
        fail(f"hard {label}: SNR kernel {s_k:.3f} dB vs plain {s_p:.3f} dB, "
             f"max|d| {err / scale:.2e} of max")
    return z, mask, tau, err


def trace_main_path(torch, run, out_dir: pathlib.Path):
    """Run ``run`` under torch.profiler; print the device's busy time, its
    idle share of the traced wall and the largest device and host
    entries."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = out_dir / "main_path_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            n, t = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, t + e["dur"])
    if not spans:
        fail("the trace holds no device activity")
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):  # union of the device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e6
    print(f"trace -> {path}: traced wall {wall:.3f} s, device busy "
          f"{busy:.3f} s (union of kernel, memcpy and memset intervals), "
          f"idle share {1 - busy / wall:.3f}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  device {t / 1e3:9.1f} ms {n:5d}x  {name[:100]}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=10, max_name_column_width=40))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", type=pathlib.Path, default=None,
                        metavar="DIR", help="trace the main path once more "
                        "and write the Chrome trace to DIR")
    args = parser.parse_args()
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    try:
        from pseudo_3d_interpolation_torch.ops import kernels  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the "
             "repository root")
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx
    from pseudo_3d_interpolation_torch.ops.kernels import _build
    from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    # the plain versions run no float32 matmul, but state the mode anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"allow_tf32=False", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    ks._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}",
          flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # phase 3: kernel against plain, ending at the main path's shapes
    cases = [(8, N, N, op, ver, 10, "highest") for op in ("soft", "hard")
             for ver in ("regular", "fast")]
    cases += [(4, 384, N, "soft", "fast", 10, "highest"),
              (4, 384, N, "hard", "fast", 10, "highest"),
              (SLICES % MAIN_BATCH, N, N, "hard", "fast", NITER, "high"),
              (MAIN_BATCH, N, N, "hard", "fast", NITER, "high")]
    max_abs_err = 0.0
    for i, case in enumerate(cases):
        z, mask, tau, err = kernel_against_plain(torch, ks, Cplx, case,
                                                 100 + i, dev)
        max_abs_err = max(max_abs_err, err)

    # timing on the last case's inputs: 32 slices of 512², 50 iterations
    def run_kernel():
        ks.pocs_solve(z, mask, tau, 0.75, "hard", "fast", "high")

    def run_plain():
        ks.pocs_solve_plain(z, mask, tau, 0.75, "hard", "fast")

    plain_a = time_ms(torch, run_plain, 2)
    kern_a = time_ms(torch, run_kernel, 2)
    kern_b = time_ms(torch, run_kernel, 2)
    plain_b = time_ms(torch, run_plain, 2)
    kernel_ms = (kern_a + kern_b) / 2
    plain_ms = (plain_a + plain_b) / 2
    gflop = 16 * N * N * (N + N) * NITER * MAIN_BATCH / 1e9
    print(f"pocs_solve {MAIN_BATCH}x{N}x{N}, {NITER} iterations: kernel "
          f"{kern_a:.2f} / {kern_b:.2f} ms ({gflop / kernel_ms:.2f} TFLOP/s "
          f"dense fp32), plain (torch.fft) {plain_a:.2f} / {plain_b:.2f} ms",
          flush=True)
    del z, mask, tau

    # phase 4: the main path, on a cube stored (iline, xline, freq)
    f = SLICES
    truth, mask = plane_waves(torch, f, N, N, 0, dev)
    obs = truth * mask
    s_in = snr_db(torch, truth, obs)
    amp = obs.permute(1, 2, 0).contiguous().cpu().numpy()
    del obs
    cube = Cube(
        coords={"iline": np.arange(N), "xline": np.arange(N),
                "freq": np.arange(f, dtype=np.float64)},
        data_vars={"amp": (("iline", "xline", "freq"), amp),
                   "fold": (("iline", "xline"),
                            mask.cpu().numpy().astype(np.int32))},
    )
    cube_gb = f * N * N * 8 / 1e9
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ks.pocs_solve.launches = 0
    t0 = time.perf_counter()
    out = interpolate(cube, device=dev)
    wall = time.perf_counter() - t0
    launches = ks.pocs_solve.launches
    peak_gb = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
    expected = math.ceil(f / MAIN_BATCH)
    if launches != expected:
        fail(f"the main path launched the pocs_solve kernel {launches} "
             f"times, not once for each of its {expected} batches")
    rec = out.data_vars["amp_interp"][1]
    if rec.shape != amp.shape:
        fail(f"output shape {rec.shape} != input {amp.shape}")
    rec = torch.from_numpy(np.moveaxis(rec, -1, 0)).to(dev)
    if not bool(torch.isfinite(rec).all()):
        fail("main-path output is not finite")
    s_out = snr_db(torch, truth, rec)
    del rec
    rate = f * NITER / wall
    print(f"main path: {f} slices of {N}x{N} stored (iline, xline, freq), "
          f"niter {NITER}, {launches} kernel launches, {wall:.2f} s wall, "
          f"{rate:.1f} slice-iterations/s; SNR {s_in:.2f} dB masked -> "
          f"{s_out:.2f} dB; device peak {peak_gb:.2f} GB = "
          f"{peak_gb / cube_gb:.2f} x the {cube_gb:.2f} GB cube pair",
          flush=True)
    if not s_out > s_in:
        fail(f"main path did not improve SNR ({s_in:.2f} -> {s_out:.2f} dB)")

    if args.trace is not None:
        del truth, out
        trace_main_path(torch, lambda: interpolate(cube, device=dev),
                        args.trace)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "pocs_solve", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
