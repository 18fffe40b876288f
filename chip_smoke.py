"""Drive the PyTorch port's main paths once on one CUDA card and check them.

Run from the repository root:

    python3 chip_smoke.py [--trace DIR]

Phases, each of which exits non-zero on failure:
1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles the CUDA sources of ``pseudo_3d_interpolation_torch``
   with nvcc for sm_90a, one nvcc per source, all started together, and
   prints the time;
3. kernels against plain, on the card:
   a. ``pocs_solve`` (FFT basis) against its plain version at 512² (batch
      8, 10 iterations, regular and fast, soft and hard thresholds), one
      384x512 rectangle, and at the shapes the FFT main path gives it
      (batch 32 and the cube's last batch of 1, 50 iterations, hard/fast
      at 'high'); times both at batch 32, and each pass of the kernel there
      (torch.profiler) with its bytes per second and flop rate, and the GB
      a call moves with the rate it reaches; runs the batch-32 call once
      at precision 'default' and asserts it bit-equal to 'high';
   b. the subband kernels' line engine (``csrc/fft_lines.cuh``, through
      ``line_fft``) against ``torch.fft`` at every line length the plans
      use, 8 to 4096 in powers of two, 384 and an odd length, forward and
      inverse; ``subband_update`` at 512² (batch 8, all 48 full-size bands
      of the plan) and on one 384x512 rectangle, and ``box_group_update``
      on both box groups of the 512² plan (16- and 40-side boxes), soft and
      hard, on the thresholds of the SHEARLET main path's decay schedule;
      times both kernels and their plain versions at the main path's batch
      of 32, and each pass of both there (torch.profiler), with its bytes
      per second and flop rate; prints ``bound_ms``, counted
      on the rows the windows touch, with their row-support fraction and
      the dense count beside it;
   c. ``pocs_iteration`` (one FFT-basis iteration) at 512² (batch 8, soft
      and hard), on one 384x512 rectangle and at the main path's batches
      32 and 1; times both at batch 32, and each of the kernel's three line
      passes there (torch.profiler) with its bytes per second and flop
      rate, and the GB a call moves with the rate it reaches;
   d. ``pocs_solve(basis='dct')`` at 512² (batch 8, 10 iterations, regular
      and fast, soft and hard), on one 384x512 rectangle, on an odd side
      (97x130, the line engine's direct DFT) and at the main path's batches
      32 and 1 (50 iterations); times both at batch 32 over 50 iterations,
      and each pass of the kernel there (torch.profiler), with the GB a call
      moves and its rate;
   e. ``pocs_solve(basis='wavelet')`` at 512² (batch 8, 10 iterations, db4
      and coif5 at level 3, soft and hard) and at the main path's batches
      32 and 1 (db4, 50 iterations); times both at batch 32 over 50
      iterations (db4), and each level's forward and inverse filter pass
      and the state kernel there, with the GB a call moves and its rate;
   f. ``subband_update_spatial`` (spatial in and out) at 512² (batches
      8, 1 and 32, the 48 full-size bands; at 32 their support rows run in
      two chunks of the scratch and only the last inverts) and on one
      384x512 rectangle, and on the CURVELET plan at 512² (batches 8, 1
      and 32) ``subband_update`` and ``subband_update_spatial`` over its
      41 full-size bands and ``box_group_update`` on its 72-side box group
      of 9 bands, soft and hard, on the thresholds of their main paths'
      decay schedules; then times the spatial kernel and the 72-side box
      group and their plain versions at batch 32, and the passes of the
      spatial kernel, of ``subband_update`` on the CURVELET plan and of the
      72-side box group as in 3b;
4. FFT main path: ``pipeline.pocs.interpolate`` with its production
   defaults on an in-memory 512x512 frequency cube of 513 slices (the
   north star's rfft slice count), stored (iline, xline, freq) as users
   store it, of plane waves under a 50% column mask; asserts one kernel
   launch per batch, a finite output and an SNR better than the masked
   input's;
5. SHEARLET main path: the same entry point, defaults and cube with
   ``transform_kind='SHEARLET'``; a first timed batch decides whether the
   whole cube fits about ten minutes (otherwise the slice count is cut
   and the cut printed); asserts one ``subband_update`` and two
   ``box_group_update`` launches per batch per iteration, a finite output
   and an SNR better than the masked input's;
6. FFT per-iteration main path: the same cube with the reference's
   recommended configuration (production defaults with eps 1e-16), route
   ``fused-periter[fft]``; asserts one ``pocs_iteration`` launch per batch
   and iteration and the output and SNR checks; prints the mean
   effective iteration count, and the SNR of the first batch on the card
   beside that of the same batch through the plain versions on the host
   (``device="cpu"``): the path ends at the float32 floor;
7. DCT main path: production defaults with ``transform_kind='DCT'``;
   asserts one ``pocs_solve[dct]`` launch per batch and the same checks;
8. WAVELET main path: production defaults with ``transform_kind=
   'WAVELET'`` (db4, level 3) and p_min 1e-5 (the adaptive minimum is
   undefined for wavelets); asserts one ``pocs_solve[wavelet]`` launch
   per batch and the same checks;
9. CURVELET main path: the production configuration of that basis
   (precision 'high' with 'highest' box groups, p_min 1e-3 as the
   adaptive minimum is shearlet-only), under phase 5's cut rule; asserts
   one ``subband_update`` and one ``box_group_update`` launch per batch
   per iteration and the same checks;
10. SHEARLET main path with ``P3D_SPATIAL_IO=1`` (set for that call only)
   on phase 5's cube: asserts one ``subband_update_spatial`` and two
   ``box_group_update`` launches per batch per iteration, no
   ``subband_update``, the same checks and an SNR within 0.1 dB of
   phase 5's.
11. the stage-2 chain: a 512x512x1024 time cube (0.25 ms samples, ten
   dipping band-limited reflectors over a 1% noise floor, made on the
   card from a seed) with about half its ilines live, chosen
   irregularly, through ``preprocess`` (rms balance, a bandpass inside
   the reflectors' band), ``apply_fft`` (513 bins), ``interpolate`` at
   its production defaults, ``apply_ifft`` and ``postprocess`` (2x2
   upsampling, footprint removal, gaussian smoothing, a 0.05 s rms AGC),
   in memory, each with ``device`` left to its default; asserts 17
   ``pocs_solve[fft]`` launches and no other kernel, an SNR after
   ``apply_ifft`` against the preprocessed truth better than the masked
   input's, a finite 1023x1023x1024 output, and each of the four steps
   around the solve on the first 32 ilines on the card within
   1e-4·max|cpu| of the same call with ``device="cpu"``; prints each
   step's wall and device peak and the chain's total.
12. the plain scan route (``xla-scan``: PyTorch ops on the card, no
   kernel) on phase 4's cube, each path through ``interpolate`` with
   ``device`` left to its default: (a) DCT at the reference's recommended
   configuration (the production defaults with eps 1e-16), route
   ``xla-scan[dct]``; (b) WAVELET (db4, level 3, p_min 1e-5) with eps
   1e-16, ``xla-scan[wavelet]``; (c) the decimated CURVELET
   (``decimated: true``, p_min 1e-3, its own 'highest'), ``xla-scan``,
   under phase 5's cut rule; (d) the FFT basis with ``hard-percentile``
   (a decay of factors, p_max 99.9, p_min 60), ``xla-scan[fft]``. Each
   asserts its route, no launch of any of the seven kernels, a finite
   output and an SNR better than the masked input's, and that
   ``torch.backends.cuda.matmul.allow_tf32`` is still False; then runs its
   first 8 slices (4 for the decimated CURVELET) through the same call on
   the card and with ``device="cpu"``, asserts the two SNRs within 0.1 dB
   and prints both mean effective iteration counts (at eps 1e-16 the stop
   sits at the float32 floor, so they may differ); prints the device peak
   beside the driver's budget for the path.
13. SEG-Y in, SEG-Y out (workflow steps 10-16): 256 SEG-Y profiles
   (format 5) along the xline axis, one on each of phase 11's live ilines
   of ``examples/pipeline.yml``'s grid (10 m bins over 5120 m, 512x512),
   2048 traces each about 2.5 m apart (about 4 a live bin), 896 samples
   at 250 us with ``DelayRecordingTime`` stepping over 0-32 ms by
   profile (a 1024-sample global axis), phase 11's reflectors sampled at
   each trace's coordinates with 1% noise, written with the port's
   ``write_segy`` to a temporary directory (removed at the end; the write
   is timed apart). (a) ``bin_cube`` with ``stack: average`` and
   ``device`` left to its default: asserts no kernel launch, the fold
   equal to a host ``np.bincount`` of the assigned bins and the cube
   within 1e-5·max|cpu| of the same call with ``device="cpu"``; prints
   the wall, traces/s, GB/s of samples read, device peak and coverage.
   (b) ``stack: median`` on the profiles of the first 64 ilines, card
   against ``device="cpu"`` within 1e-6·max, fold exact. (c) the binned
   cube through ``preprocess`` (rms balance), ``apply_fft``,
   ``interpolate`` (production defaults), ``apply_ifft`` and
   ``postprocess`` (0.05 s AGC) in memory, then ``cube_to_segy`` to a
   temporary file: asserts 17 ``pocs_solve[fft]`` launches and no other
   kernel, an SNR after ``apply_ifft`` against the preprocessed truth on
   the grid better than the binned input's, and the file read back with
   the port's ``SegyFile``: 512·512 traces, ``INLINE_3D`` and
   ``CROSSLINE_3D`` the grid's, ``NStackedTraces`` the fold, dt and delay,
   the samples bit for bit; prints each step's wall and their sum.
14. the cube drivers and the out-of-core passes: (a) ``warmup`` of the
   production FFT and SHEARLET solves at 512x512 with 513 slices, one
   launch of the resident driver each (one ``pocs_solve[fft]``, or 50
   ``subband_update`` and 100 ``box_group_update``); (b)
   ``pocs_interpolate_scanned`` on phase 4's cube held on the card
   (padded with zero slices to a multiple of the batch) against
   ``interpolate_cube_resident`` on the same slices; (c) the host-chunked
   ``interpolate_cube`` against the resident driver on phase 4's FFT cube
   and phase 5's SHEARLET cube, walls and device peaks; (d)
   ``pad_to_tile=True`` against ``None`` through ``interpolate`` on a
   500x500 cut of phase 4's cube, beside phase 4's 512x512 wall, and the
   padded solve's first 4 slices against ``device="cpu"`` by SNR within
   0.1 dB; (e) the streamed preprocess and postprocess slab loops
   (``preprocess_slabs``: phase 11's chain options; ``postprocess_slabs``:
   2x2 upsampling, footprint removal, gaussian smoothing with
   ``rescale_percentiles``, a 0.05 s AGC) over phase 11's 512x512x1024
   time cube from an in-memory source into an in-memory sink
   (``tests/torch_helpers.py``), each against the in-memory step on the
   card within 1e-6·max, with walls, bytes read and written and device
   peaks; and ``streamed_percentiles`` of blocks on the card, which must
   equal ``numpy.percentile`` on the host exactly; (f) where h5py imports,
   ``interpolate_checkpointed`` and both streamed passes on files in a
   temporary directory against the in-memory steps (otherwise one line
   says that 14f did not run). Each path asserts its launches (none on
   14e). Drivers are held to equal iteration counts and outputs within
   1e-6·max (printed as bit-equal when they are).
15. stage 1 (workflow steps 01-08) on ``stage1_survey_32``
   (``tests/torch_helpers.write_stage1_survey``): 30 parallel profiles
   and 2 tie lines crossing all of them (60 crossings), 2048 traces of
   896 samples at 250 us each, in WGS84 degrees, written to a temporary
   directory: line 0 ends in a short file after a 3-trace recording gap,
   a run of wrong delays on every line, the tie lines recorded from
   another delay, heave jitter, a tide CSV, one line recorded 1 ms deep
   and spikes. Steps 01 merge, 02 reproject (to UTM 32N), 03
   delrt_correct, 04 delrt_pad, 05 static_correct, 06 tide_compensate,
   07 mistie_correct and 08 despike run through their entry points with
   ``device`` left to its default, each under torch.profiler: prints each
   step's wall, MB/s of samples, the card's busy time (the union of its
   kernel, memcpy and memset intervals) and the host's share, the device
   peak, and the mistie intersection search's seconds (``--trace`` keeps
   each step's Chrome trace). Asserts no launch of the seven kernels;
   the repairs against what the survey injected (delays exact, picks and
   the flattened seafloor within a sample, tide shifts exact, the mistie
   within a sample, every spike found and removed); and each device step
   (03, 05-08) on the card equal to ``device="cpu"`` on four profiles
   (07: a tie line and three lines it crosses, both runs on copies):
   headers and samples bit for bit, sidecars as numbers (misties.csv's
   correlations within 1e-6). Steps 01, 02 and 04 are host numpy and
   take no device.
Phases 4 to 10 and 12 print the wall time, slice-iterations/s and device
peak memory. Before each, and before phase 11's and 13c's chains, 13a's
binning and phase 15's steps, every kernel's
launch count is set to 0; after it, the counts of all seven kernels must
be the path's own (zero for the others, and for every kernel on phase
12's paths, 13a's binning and phase 15).

Tolerances, kernel against plain: soft thresholds max|Δ| ≤ 1e-4·max|plain|
(fp32 sums in another order; for ``pocs_solve`` also √cost within 1e-6);
hard thresholds flip coefficients at the threshold under reordered
arithmetic, so kernel and plain are compared by SNR against the truth,
within 0.1 dB (``pocs_solve`` after 50 iterations, where both sit at the
float32 floor, by the elementwise bound instead). The subband kernels'
SNR is that of one whole POCS iterate: the kernel's output combined with
the other kernel's plain output, inverted and reinserted.

``--trace DIR`` runs each main path once more under ``torch.profiler``
(the SHEARLET, per-iteration, CURVELET and spatial-I/O paths and phase
12's four on their first two batches, 64 slices; the stage-2 chain,
phase 13a's binning and 14e's slab loops whole; 14c's host-chunked
driver on the first two batches), writes the Chrome
traces to ``DIR`` (gzipped) and prints the device's busy time (the union
of kernel, memcpy and memset intervals), its idle share of the traced wall
time, the copies by kind, and the largest device and host entries. Phase 3's profiles of the
solves and of the iteration fail on any device activity but their own
passes: no dense product runs in them.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists each kernel with its launch count, error, times
and bound (``bound_ms``: the larger of the bytes the call must move over
3.35 TB/s and its operations over 67 TFLOP/s fp32, the H100 SXM data
sheet's rates at 700 W). Operations are counted as a fast transform does
the work: 5·n·log2 n flops per complex 2-D FFT of n points (the FFT
solve and iteration), and 5·n·log2 n per complex 1-D FFT of n points;
2.5·n·log2 n per real 2-D DCT of n points, four per slice-iteration (re
and im, forward and inverse: the DCT solve); 2·L flops per output of each
1-D filter pass of a length-L wavelet, two passes per level, forward and
inverse, re and im (the wavelet solve; the kernel's filter passes do
twice that, 4·L flops per complex output of a pass). The subband kernels'
work depends
on the windows: their ``bound_ms`` counts the 1-D FFTs of the rows that
hold a nonzero of a window, each way, and of every column of every band,
each way, plus the spatial kernel's two 2-D FFTs (``subband_bound``); the
dense count of 2·L full 2-D FFTs per slice (2·L + 2 spatial) is printed
beside it (3b, 3f).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import inspect
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

CSRC = "pseudo_3d_interpolation_torch/csrc/"
PALLAS = "pseudo_3d_interpolation_tpu/ops/pallas/"
# soft thresholds: fp32 sums in another order than the plain version's
SOFT_TOL = 1e-4
# hard thresholds flip coefficients at the threshold under reordered
# arithmetic, so kernel and plain are compared by SNR against the truth;
# after 50 iterations pocs_solve and its plain version both reach the
# float32 rounding floor against the truth, where the SNRs' difference
# measures rounding alone: there the elementwise bound SOFT_TOL also
# passes the case
SNR_TOL_DB = 0.1
# the cost is (d/s)² with d a small difference of two float32 slice sums:
# sqrt(cost) carries their rounding directly
SQRT_COST_ATOL = 1e-6
N = 512
SLICES = 513  # rfft bins of a 1024-sample trace (BASELINE.md:24)
MAIN_BATCH = 32  # the resident driver's batch (pipeline/pocs.py)
NITER = 50  # the production default
ALPHA = 0.75
TAU_ITER = 10  # phase 3b thresholds: this iteration of the schedule
WALL_LIMIT_S = 600  # the SHEARLET cube is cut to fit this
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# H100 SXM data sheet at 700 W
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms of a call and what sets it."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def fft2_flops(h: int, w: int) -> float:
    """5·n·log2 n flops of one complex 2-D transform of n = h·w points."""
    return 5.0 * h * w * math.log2(h * w)


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


def decay_for(torch, obs, niter, basis="fft", wavelet=None):
    """The exponential schedule the solver derives for a batch of observed
    slices (p_max 0.99; adaptive p_min, or 1e-5 for the wavelet, where it
    is undefined): (niter, B), or (niter, B, 3·level) per wavelet band,
    deepest level first."""
    from pseudo_3d_interpolation_torch.models.transforms import get_transform
    from pseudo_3d_interpolation_torch.ops import decay, dft

    if basis == "fft":
        return decay.threshold_decay(dft.fft2(obs).abs(), "exponential",
                                     niter, p_max=0.99,
                                     p_min="adaptive").contiguous()
    if basis == "dct":
        tr = get_transform("DCT")
        return tr.decay(tr.forward(obs), "exponential", niter, 0.99,
                        "adaptive", "values").contiguous()
    tr = get_transform("WAVELET", wavelet=wavelet, level=3).with_shape(
        obs.shape)
    tree = tr.decay(tr.forward(obs), "exponential", niter, 0.99, 1e-5,
                    "values")
    return torch.stack([leaf for det in tree[1:] for leaf in det],
                       dim=-1).contiguous()


def wavelet_mats(n, name):
    from pseudo_3d_interpolation_torch.ops import wavelet as wv

    return [wv.dwt_matrix(n >> j, name) for j in range(3)]


def time_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_pair(torch, kernel, plain, reps):
    """(kernel ms, plain ms), each the mean of two timings taken in the
    order plain, kernel, kernel, plain, after one untimed call of each (the
    first call may wait on the allocator for its scratch); prints all
    four."""
    plain()
    kernel()
    p_a = time_ms(torch, plain, reps)
    k_a = time_ms(torch, kernel, reps)
    k_b = time_ms(torch, kernel, reps)
    p_b = time_ms(torch, plain, reps)
    return (k_a + k_b) / 2, (p_a + p_b) / 2, (k_a, k_b, p_a, p_b)


def kernel_against_plain(torch, ks, Cplx, case, seed, dev, basis="fft",
                         wavelet=None):
    """Run pocs_solve and its plain version on one case of a basis, check
    them, print the comparison. Returns the inputs and max|Δ|."""
    b, h, w, op, ver, niter, precision = case
    truth, mask = plane_waves(torch, b, h, w, seed, dev)
    obs = truth * mask
    z = Cplx(obs.real.contiguous(), obs.imag.contiguous())
    tau = decay_for(torch, z, niter, basis, wavelet)
    kw = {"basis": basis}
    if wavelet:
        kw["wavelet_mats"] = wavelet_mats(h, wavelet)
    res, cost = ks.pocs_solve(z, mask, tau, ALPHA, op, ver, precision, **kw)
    ref, ref_cost = ks.pocs_solve_plain(z, mask, tau, ALPHA, op, ver, **kw)
    got = torch.complex(res.re, res.im)
    want = torch.complex(ref.re, ref.im)
    name = f"pocs_solve[{basis}]" + (f" {wavelet}" if wavelet else "")
    label = f"{b}x{h}x{w} {op}/{ver} niter {niter} '{precision}'"
    if not bool(torch.isfinite(got).all()):
        fail(f"{name} output not finite at {label}")
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    s_k, s_p = snr_db(torch, truth, got), snr_db(torch, truth, want)
    print(f"{name} vs plain {label}: max|d|={err:.3e} ({err / scale:.2e}"
          f" of max), SNR kernel {s_k:.3f} dB, plain {s_p:.3f} dB",
          flush=True)
    if op == "soft":
        if err > SOFT_TOL * scale:
            fail(f"{name} soft {label}: max|d| {err:.3e} > {SOFT_TOL} of "
                 f"max|plain| {scale:.3e}")
        c_err = float(torch.max(torch.abs(torch.sqrt(cost)
                                          - torch.sqrt(ref_cost))))
        if c_err > SQRT_COST_ATOL:
            fail(f"{name} soft {label}: sqrt(final cost) differs by "
                 f"{c_err:.2e}")
    elif abs(s_k - s_p) > SNR_TOL_DB and not (
            niter == NITER and err <= SOFT_TOL * scale):
        fail(f"{name} hard {label}: SNR kernel {s_k:.3f} dB vs plain "
             f"{s_p:.3f} dB, max|d| {err / scale:.2e} of max")
    return z, mask, tau, err


def iteration_against_plain(torch, ks, Cplx, b, h, w, op, seed, dev):
    """Run pocs_iteration and its plain version on the first iterate of
    the main path (x = obs, iteration TAU_ITER's thresholds), check them
    like a solve. Returns the inputs and max|Δ|."""
    truth, mask = plane_waves(torch, b, h, w, seed, dev)
    obs = truth * mask
    z = Cplx(obs.real.contiguous(), obs.imag.contiguous())
    tau = decay_for(torch, z, NITER)[TAU_ITER].contiguous()
    got = ks.pocs_iteration(z, z, mask, tau, ALPHA, op, "high")
    want = ks.pocs_iteration_plain(z, z, mask, tau, ALPHA, op)
    got, want = torch.complex(got.re, got.im), torch.complex(want.re,
                                                             want.im)
    label = f"pocs_iteration {b}x{h}x{w} {op}"
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: output not finite")
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    s_k, s_p = snr_db(torch, truth, got), snr_db(torch, truth, want)
    print(f"{label} vs plain: max|d|={err:.3e} ({err / scale:.2e} of max),"
          f" SNR kernel {s_k:.3f} dB, plain {s_p:.3f} dB", flush=True)
    if op == "soft" and err > SOFT_TOL * scale:
        fail(f"{label}: max|d| {err:.3e} > {SOFT_TOL} of max|plain|")
    if op == "hard" and abs(s_k - s_p) > SNR_TOL_DB:
        fail(f"{label}: SNR kernel {s_k:.3f} dB vs plain {s_p:.3f} dB")
    return z, mask, tau, err


class SubbandCase:
    """Phase 3b and 3f inputs for one slice shape and spectral-stack basis:
    plane waves under the column mask, the plan's kernel packing, the
    slices, their spectrum and the thresholds of iteration TAU_ITER of the
    main path's decay schedule (SHEARLET: adaptive p_min; CURVELET: its
    production 1e-3)."""

    def __init__(self, torch, b, h, w, seed, dev, basis="SHEARLET"):
        from pseudo_3d_interpolation_torch.models.transforms import (
            get_transform)
        from pseudo_3d_interpolation_torch.ops import shearlet as sh
        from pseudo_3d_interpolation_torch.ops.cplx import Cplx

        self.torch, self.h, self.w, self.b = torch, h, w, b
        self.truth, self.mask = plane_waves(torch, b, h, w, seed, dev)
        self.obs = self.truth * self.mask
        z = Cplx(self.obs.real.contiguous(), self.obs.imag.contiguous())
        self.x = z
        tr = get_transform(basis, precision="high")
        p_min = "adaptive" if basis == "SHEARLET" else 1e-3
        tau = tr.decay_from_input(z, "exponential", NITER, 0.99, p_min,
                                  "values")[TAU_ITER]
        self.full, full_idx, self.boxes = sh._plan_kernel_pack(
            tr._plan(h, w), h, w)
        self.psi = self.full.psi_on(dev)
        self.support = self.full.support_on(dev)
        self.chunks = self.support.chunks(b, h, w)[0]
        self.tau_full = tau[:, torch.from_numpy(full_idx).to(dev)].contiguous()
        self.tau = tau.contiguous()
        self.zf = torch.fft.fft2(self.obs)
        self.spec = Cplx(self.zf.real.contiguous(), self.zf.imag.contiguous())
        self.dev = dev

    def box_args(self, k, op):
        """(the box's selection, the plain version's arguments, the
        kernel's ``index``) of box group k."""
        from pseudo_3d_interpolation_torch.ops.cplx import Cplx

        l0, lg, g = self.boxes[k]
        ih, iw = g.index_on(self.dev)
        sel = (slice(None), ih[:, None], iw[None, :])
        box = self.zf[sel]
        return sel, (Cplx(box.real.contiguous(), box.imag.contiguous()),
                     g.psi_on(self.dev),
                     self.tau[:, l0:l0 + lg].contiguous(),
                     g.box_mats_on(self.h, self.w, self.dev), self.h, self.w,
                     op), g.box_index_on(self.h, self.w, self.dev)

    def iterate_snr(self, acc, box_sums) -> float:
        """SNR against the truth of the POCS iterate whose spectral
        accumulator is ``acc`` plus the box groups' ``(sel, sum)``."""
        torch = self.torch
        acc = acc.clone()
        for sel, m in box_sums:
            acc[sel] += m
        x = torch.fft.ifft2(acc) * (1.0 - ALPHA * self.mask) + ALPHA * self.obs
        return snr_db(torch, self.truth, x)


def compare(torch, label, op, got, want, snr_k, snr_p):
    """Check one subband-kernel case; returns max|Δ|."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: kernel output not finite")
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    print(f"{label} {op}: max|d|={err:.3e} ({err / scale:.2e} of max), "
          f"iterate SNR kernel {snr_k:.3f} dB, plain {snr_p:.3f} dB",
          flush=True)
    if op == "soft" and err > SOFT_TOL * scale:
        fail(f"{label} soft: max|d| {err:.3e} > {SOFT_TOL} of max|plain| "
             f"{scale:.3e}")
    if op == "hard" and abs(snr_k - snr_p) > SNR_TOL_DB:
        fail(f"{label} hard: iterate SNR kernel {snr_k:.3f} dB vs plain "
             f"{snr_p:.3f} dB")
    return err


def subband_kernels_against_plain(torch, ksb, case, ops, with_boxes,
                                  spatial=False):
    """Phase 3b, or with ``spatial`` the spatial kernel of phase 3f, on one
    SubbandCase; returns (max|Δ| subband, box). The spatial kernel's
    output enters the iterate SNR through its fft2."""
    c = case
    cplx = torch.complex
    err_a = err_b = 0.0
    for op in ops:
        if spatial:
            want_a = ksb.subband_update_spatial_plain(c.x, c.psi, c.tau_full,
                                                      op)
            got_a = ksb.subband_update_spatial(c.x, c.psi, c.tau_full, op,
                                               "high", support=c.support)
        else:
            want_a = ksb.subband_update_plain(c.spec, c.psi, c.tau_full, op)
            got_a = ksb.subband_update(c.spec, c.psi, c.tau_full, op, "high",
                                       support=c.support)
        box_plain = []
        for k in range(len(c.boxes)):
            sel, args, _ = c.box_args(k, op)
            m = ksb.box_group_update_plain(*args)
            box_plain.append((sel, cplx(m.re, m.im)))
        want_a, got_a = cplx(want_a.re, want_a.im), cplx(got_a.re, got_a.im)
        name = "subband_update_spatial" if spatial else "subband_update"
        label = f"{name} {c.b}x{c.h}x{c.w} ({c.psi.shape[0]} bands)"
        spec = torch.fft.fft2 if spatial else (lambda a: a)
        err_a = max(err_a, compare(
            torch, label, op, got_a, want_a,
            c.iterate_snr(spec(got_a), box_plain),
            c.iterate_snr(spec(want_a), box_plain)))
        if not with_boxes:
            continue
        for k in range(len(c.boxes)):
            sel, args, index = c.box_args(k, op)
            got_b = ksb.box_group_update(*args, "high", index=index)
            got_b = cplx(got_b.re, got_b.im)
            want_b = box_plain[k][1]
            with_k = [(s, got_b if j == k else m)
                      for j, (s, m) in enumerate(box_plain)]
            label = (f"box_group_update {c.b}x{len(sel[1])}x"
                     f"{sel[2].shape[1]} of {c.h}x{c.w}")
            err_b = max(err_b, compare(
                torch, label, op, got_b, want_b,
                c.iterate_snr(spec(want_a), with_k),
                c.iterate_snr(spec(want_a), box_plain)))
    return err_a, err_b


def time_box(torch, ksb, case, k):
    """Time box group k of a SubbandCase at its batch, kernel and plain,
    and each pass of the kernel; returns (kernel ms, plain ms, bound)."""
    _, lg, g = case.boxes[k]
    _, bargs, index = case.box_args(k, "hard")
    t_k, t_p, four = time_pair(
        torch, lambda: ksb.box_group_update(*bargs, "high", index=index),
        lambda: ksb.box_group_update_plain(*bargs), 5)
    side = len(g.idx_h)
    # a pruned FFT: the field from the box's `side` nonzero columns, then
    # along every row; the same back to the box
    flops = 2 * case.b * lg * 5.0 * (side * N * math.log2(N)
                                     + N * N * math.log2(N))
    bnd = bound(flops, case.b * side * side * 16 + lg * side * side * 4
                + case.b * lg * 4 + 2 * side * N * 8)
    print(f"box_group_update {case.b}x{side}x{side} ({lg} bands) of "
          f"{case.h}x{case.w}: kernel {four[0]:.3f} / {four[1]:.3f} ms, "
          f"plain (torch.matmul) {four[2]:.3f} / {four[3]:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    # the passes: (1) the box columns into field columns, (2) every field
    # row both ways, (3) the field columns back to the box, band-summed
    b, nh, nw = case.b, case.h, case.w
    field = b * lg * side * nh * 8  # the scratch G, bytes
    col_flops = b * lg * side * 5.0 * nh * math.log2(nh)
    print_passes(f"box_group_update {b}x{side}x{side}", kernel_passes(
        torch, lambda: ksb.box_group_update(*bargs, "high", index=index),
        BOX_PASSES), {
        "box_cols_inverse_kernel": (b * side * side * 8 + field, col_flops),
        "box_rows_kernel": (2 * field, 2 * b * lg * nh * 5.0 * nw
                            * math.log2(nw)),
        "box_cols_forward_kernel": (field + b * side * side * 8, col_flops)})
    return t_k, t_p, bnd


LINE_LENGTHS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 384, 97)


def line_engine_against_plain(torch, ksb, Cplx, dev) -> float:
    """The subband kernels' line engine alone against ``torch.fft`` at
    every line length the plans use (powers of two from 8 to 4096, the
    rectangle's 384 and an odd length), forward and inverse, within
    SOFT_TOL of max; returns the largest relative max|Δ|."""
    rng = np.random.default_rng(800)
    worst = 0.0
    for n in LINE_LENGTHS:
        x = Cplx(*(torch.as_tensor(rng.normal(size=(64, n)),
                                   dtype=torch.float32, device=dev)
                   for _ in range(2)))
        for inverse in (False, True):
            got = ksb.line_fft(x, inverse)
            want = ksb.line_fft_plain(x, inverse)
            got = torch.complex(got.re, got.im)
            want = torch.complex(want.re, want.im)
            if not bool(torch.isfinite(got).all()):
                fail(f"line engine n={n} inverse={inverse}: not finite")
            rel = float(torch.max(torch.abs(got - want))
                        / torch.max(torch.abs(want)))
            worst = max(worst, rel)
            if rel > SOFT_TOL:
                fail(f"line engine n={n} inverse={inverse}: max|d| "
                     f"{rel:.2e} of max > {SOFT_TOL}")
    print(f"line engine vs torch.fft at n = {LINE_LENGTHS}, forward and "
          f"inverse: max|d| <= {worst:.2e} of max", flush=True)
    return worst


# a pass of each line-FFT kernel by its kernel's name in the trace
PASS_NAMES = ("rows_inverse_kernel", "cols_shrink_kernel",
              "rows_forward_acc_kernel", "cols_fft_kernel",
              "rows_fft_kernel")
BOX_PASSES = ("box_cols_inverse_kernel", "box_rows_kernel",
              "box_cols_forward_kernel")
SOLVE_PASSES = ("solve_rows_forward_kernel", "solve_cols_shrink_kernel",
                "solve_rows_inverse_kernel", "state_kernel", "init_kernel")
ITER_PASSES = SOLVE_PASSES[:3]
WAVELET_PASSES = ("wavelet_forward_kernel", "wavelet_inverse_kernel",
                  "state_kernel", "init_kernel")


PROFILE_ATTEMPTS = 3  # profiles taken of one run before a missing pass fails


def profiled_events(torch, run, reps: int, want=()) -> list:
    """The device events of ``reps`` calls of ``run`` under torch.profiler,
    after one untimed call, in the order they started. The profiler now
    and then hands back a trace without the device's kernels, so the
    profile is taken again, up to PROFILE_ATTEMPTS times, while no event
    names a kernel of ``want``; each such attempt is printed with what
    its trace held. The caller fails on a pass still missing."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            events = device_events(prof, pathlib.Path(tmp) / "passes.json")
        missing = [n for n in want
                   if not any(n in e["name"] for e in events)]
        if not missing:
            break
        seen = sorted({e["name"][:40] for e in events})[:4]
        print(f"profile attempt {attempt} of {PROFILE_ATTEMPTS}: the trace "
              f"({len(events)} device events, e.g. {seen}) holds no "
              f"{', '.join(missing)}", flush=True)
    return sorted(events, key=lambda e: e["ts"])


def only_passes(events: list, names) -> list:
    """``events``, failing on any whose name contains none of ``names``."""
    for e in events:
        if not any(n in e["name"] for n in names):
            fail(f"{e['name'][:80]} ran in a profile of {names}")
    return events


def kernel_passes(torch, run, names, reps: int = 3,
                  exclusive: bool = False, want=None) -> dict:
    """ms per call of each pass (device kernel, by a name in ``names``
    that its trace name contains, the longest such name) of ``reps``
    calls of ``run`` under torch.profiler, after one untimed call, taken
    again while a pass of ``want`` (all of ``names`` by default) is
    missing; with ``exclusive`` fails when anything else ran on the
    device."""
    times = dict.fromkeys(names, 0.0)
    events = profiled_events(torch, run, reps,
                             names if want is None else want)
    if exclusive:
        only_passes(events, names)
    for e in events:
        hits = [n for n in names if n in e["name"]]
        if hits:
            times[max(hits, key=len)] += e["dur"] / 1e3 / reps
    return times


def print_total(label, times: dict, work: dict):
    """Print the GB the passes of ``work`` move a call and the rate they
    reach over their summed time."""
    ms = sum(times.values())
    nbytes = sum(b for b, _ in work.values())
    print(f"{label}: the passes move {nbytes / 1e9:.3f} GB a call, "
          f"{nbytes / ms / 1e9:.3f} TB/s over their {ms:.3f} ms", flush=True)


def print_passes(label, times: dict, work: dict) -> dict:
    """Print each pass of ``work`` ({pass: (bytes, flops)} per call) with
    its ms per call, bytes per second and flop rate; fails when the trace
    holds no such pass. Returns {pass: ms per call}."""
    print(f"{label} per pass, per call:", flush=True)
    for name, (nbytes, flops) in work.items():
        ms = times[name]
        if ms <= 0:
            fail(f"{label}: the trace holds no {name}")
        print(f"  {name:26s} {ms:8.3f} ms  {nbytes / ms / 1e9:7.3f} TB/s  "
              f"{flops / ms / 1e9:7.2f} TFLOP/s", flush=True)
    return {k: times[k] for k in work}


def pass_work(case, spatial: bool) -> dict:
    """(bytes, flops) of each pass of one subband call on a SubbandCase,
    counted on the rows the kernel transforms: S support rows over the
    bands, L bands, C band chunks. (a) reads X and ψ and writes the
    scratch on the S rows, one W-line FFT each; (b) reads and writes the
    scratch's S rows, two H-line FFTs of every column of every band; (c)
    reads the scratch and ψ on the S rows, one W-line FFT each, and writes
    the accumulator C times, reading it C − 1 times (and with ``spatial``
    one more inverse W-line FFT of every row); spatial only: the column
    passes read and write a plane pair with one H-line FFT per column, the
    row pass one W-line FFT per row, each twice."""
    b, h, w = case.b, case.h, case.w
    offsets = case.support.offsets
    s_rows = int(offsets[-1])
    nbands = len(offsets) - 1
    chunks = len(case.chunks) - 1
    lw, lh = 5.0 * w * math.log2(w), 5.0 * h * math.log2(h)
    work = {
        "rows_inverse_kernel": (b * s_rows * w * 20, b * s_rows * lw),
        "cols_shrink_kernel": (b * s_rows * w * 16, b * nbands * w * 2 * lh),
        "rows_forward_acc_kernel": (
            b * s_rows * w * 12 + (2 * chunks - 1) * b * h * w * 8,
            b * s_rows * lw + spatial * b * h * lw)}
    if spatial:
        work["cols_fft_kernel"] = (2 * b * h * w * 16, 2 * b * w * lh)
        work["rows_fft_kernel"] = (b * h * w * 16, b * h * lw)
    return work


def subband_passes(torch, ksb, case, spatial: bool) -> dict:
    """Time and print each pass of a subband call on a SubbandCase
    (pass_work's counts); returns {pass: ms per call}."""
    if spatial:
        def run():
            ksb.subband_update_spatial(case.x, case.psi, case.tau_full,
                                       "hard", "high", support=case.support)
    else:
        def run():
            ksb.subband_update(case.spec, case.psi, case.tau_full, "hard",
                               "high", support=case.support)
    label = ("subband_update_spatial" if spatial else "subband_update")
    work = pass_work(case, spatial)
    return print_passes(
        f"{label} {case.b}x{case.h}x{case.w} ({case.psi.shape[0]} bands, "
        f"{len(case.chunks) - 1} chunks)",
        kernel_passes(torch, run, PASS_NAMES, want=work), work)


def solve_passes(torch, ks, z, mask, tau, basis: str = "fft") -> dict:
    """Time and print each pass of one FFT- or DCT-basis pocs_solve call
    at (B, H, W) with ``tau``'s iterations: per iteration (a) reads y and
    writes t with one W-line FFT a row, (b) reads and writes t with two
    H-line FFTs a column, (c) reads t, obs and x (the mask once) and
    writes y with one W-line FFT a row, the state kernel reads y and x
    and writes both (the DCT's steps around the FFTs uncounted); then the
    GB a call moves and its rate. Fails if anything else ran."""
    b, h, w = z.re.shape
    niter = tau.shape[0]
    px = niter * b * h * w
    rows = px * 5.0 * math.log2(w)
    label = f"pocs_solve[{basis}] {b}x{h}x{w}, {niter} iterations"
    work = {"solve_rows_forward_kernel": (16 * px, rows),
            "solve_cols_shrink_kernel": (16 * px,
                                         2 * px * 5.0 * math.log2(h)),
            "solve_rows_inverse_kernel": (32 * px + 4 * h * w, rows),
            "state_kernel": (32 * px, 0.0),
            "init_kernel": (24 * b * h * w, 0.0)}
    times = print_passes(label, kernel_passes(
        torch, lambda: ks.pocs_solve(z, mask, tau, ALPHA, "hard", "fast",
                                     "high", basis=basis),
        SOLVE_PASSES, 2, True), work)
    print_total(label, times, work)
    return times


def iteration_passes(torch, ks, z, mask, tau) -> dict:
    """Time and print each pass of one pocs_iteration call at (B, H, W):
    (a) reads x and writes t with one W-line FFT a row, (b) reads and
    writes t with two H-line FFTs a column, (c) reads t and obs (the mask
    once) and writes the result with one W-line FFT a row; then the GB a
    call moves and its rate. Fails if anything else ran."""
    b, h, w = z.re.shape
    px = b * h * w
    rows = px * 5.0 * math.log2(w)
    label = f"pocs_iteration {b}x{h}x{w}"
    work = {"solve_rows_forward_kernel": (16 * px, rows),
            "solve_cols_shrink_kernel": (16 * px,
                                         2 * px * 5.0 * math.log2(h)),
            "solve_rows_inverse_kernel": (24 * px + 4 * h * w, rows)}
    times = print_passes(label, kernel_passes(
        torch, lambda: ks.pocs_iteration(z, z, mask, tau, ALPHA, "hard",
                                         "high"), ITER_PASSES, 20, True), work)
    print_total(label, times, work)
    return times


def wavelet_passes(torch, ks, z, mask, tau, mats, reps: int = 2) -> dict:
    """Time and print each pass of one wavelet pocs_solve call at (B, n, n)
    with ``tau``'s iterations: per level lv (block nj = n >> lv) its
    forward filter pass (reads the block, writes its four quadrants) and
    its inverse pass (reads the coefficients, writes the block; level 0
    also reads obs, x and the mask and writes y), 8·L flops per output
    each; the state kernel (reads y and x, writes both) and init. A
    level's pass is known by its place in the iteration's launch order
    (forward finest first, inverse deepest first). Then the GB a call
    moves and its rate. Fails if anything else ran."""
    b, n, _ = z.re.shape
    niter, level = tau.shape[0], len(mats)
    taps = ks.wavelet_taps(mats).size // 2
    times, fwd, inv = {}, 0, 0
    for e in only_passes(profiled_events(torch, lambda: ks.pocs_solve(
            z, mask, tau, ALPHA, "hard", "fast", "high", basis="wavelet",
            wavelet_mats=mats), reps, WAVELET_PASSES), WAVELET_PASSES):
        name = e["name"]
        if "wavelet_forward_kernel" in name:
            key = f"forward level {fwd % level}"
            fwd += 1
        elif "wavelet_inverse_kernel" in name:
            key = f"inverse level {level - 1 - inv % level}"
            inv += 1
        elif "state_kernel" in name or "init_kernel" in name:
            key = "state_kernel" if "state" in name else "init_kernel"
        else:
            continue
        times[key] = times.get(key, 0.0) + e["dur"] / 1e3 / reps
    work = {}
    for lv in range(level):
        px = niter * b * (n >> lv) ** 2
        work[f"forward level {lv}"] = (16 * px, 8 * taps * px)
    for lv in range(level - 1, -1, -1):
        px = niter * b * (n >> lv) ** 2
        work[f"inverse level {lv}"] = (
            (32 * px + niter * 4 * n * n) if lv == 0 else 16 * px,
            8 * taps * px)
    work["state_kernel"] = (32 * niter * b * n * n, 0.0)
    work["init_kernel"] = (24 * b * n * n, 0.0)
    label = (f"pocs_solve[wavelet] {b}x{n}x{n}, L = {taps}, level {level}, "
             f"{niter} iterations")
    times = print_passes(label, dict.fromkeys(work, 0.0) | times, work)
    print_total(label, times, work)
    return times


def subband_bound(label, case, spatial: bool) -> tuple[float, str]:
    """The bound of one subband call on a SubbandCase: the operations of
    the rows its windows touch (pass_work's flops, whose column FFTs are
    counted dense) and the bytes of the slices in and out, the windows and
    the thresholds. Prints it with the windows' row-support fraction and,
    beside it, the dense count of 2·L full 2-D FFTs per slice (2·L + 2
    spatial), which ignores the rows the kernels skip."""
    b, h, w, nbands = case.b, case.h, case.w, case.psi.shape[0]
    flops = sum(f for _, f in pass_work(case, spatial).values())
    nbytes = b * h * w * 16 + nbands * h * w * 4 + b * nbands * 4
    bnd = bound(flops, nbytes)
    dense = bound((2 * nbands + 2 * int(spatial)) * fft2_flops(h, w) * b,
                  nbytes)
    frac = float(case.support.offsets[-1]) / (nbands * h)
    print(f"{label} {b}x{h}x{w}: bound_ms {bnd[0]:.4f} ({bnd[1]}, "
          f"{flops / 1e9:.1f} GFLOP on the support rows, support fraction "
          f"{frac:.4f} of the bands' rows); dense count {dense[0]:.4f} ms",
          flush=True)
    return bnd


def device_events(prof, path: pathlib.Path) -> list:
    """The device events (kernel, memcpy, memset) of a finished profile,
    read back from its Chrome trace, written to ``path``."""
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_seconds(events) -> float:
    """The union of the device intervals of a trace's events, in s."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def trace_main_path(torch, run, out_dir: pathlib.Path, name: str):
    """Run ``run`` under torch.profiler; print the device's busy time, its
    idle share of the traced wall and the largest device and host
    entries; keep the Chrome trace as ``DIR/<name>.json.gz``."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    raw = out_dir / f"{name}.json"
    events = device_events(prof, raw)
    with open(raw, "rb") as src, gzip.open(f"{raw}.gz", "wb") as dst:
        dst.write(src.read())
    raw.unlink()
    by_name = {}
    for e in events:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    if not events:
        fail(f"the {name} trace holds no device activity")
    busy = busy_seconds(events)
    print(f"trace -> {raw}.gz: traced wall {wall:.3f} s, device busy "
          f"{busy:.3f} s (union of kernel, memcpy and memset intervals), "
          f"idle share {1 - busy / wall:.3f}")
    copies = {}
    for e in events:
        if e["cat"] == "gpu_memcpy":
            n, t = copies.get(e["name"], (0, 0.0))
            copies[e["name"]] = (n + 1, t + e["dur"])
    for kname, (n, t) in sorted(copies.items()):
        print(f"  copies {t / 1e3:9.1f} ms {n:6d}x  {kname[:60]}")
    for kname, (n, t) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"  device {t / 1e3:9.1f} ms {n:6d}x  {kname[:100]}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=10, max_name_column_width=40))


def make_cube(torch, Cube, truth, mask):
    """The masked truth as a Cube stored (iline, xline, freq)."""
    f = truth.shape[0]
    obs = truth * mask
    amp = obs.permute(1, 2, 0).contiguous().cpu().numpy()
    return Cube(
        coords={"iline": np.arange(N), "xline": np.arange(N),
                "freq": np.arange(f, dtype=np.float64)},
        data_vars={"amp": (("iline", "xline", "freq"), amp),
                   "fold": (("iline", "xline"),
                            mask.cpu().numpy().astype(np.int32))},
    ), snr_db(torch, truth, obs)


KERNELS = ("pocs_solve[fft]", "pocs_solve[dct]", "pocs_solve[wavelet]",
           "pocs_iteration", "subband_update", "subband_update[spatial]",
           "box_group_update")


def launch_counts(ks, ksb) -> dict:
    """Every kernel's launch count, by the names of the ``kernels`` line."""
    by_basis = ks.pocs_solve.launches_by_basis
    return {"pocs_solve[fft]": by_basis["fft"],
            "pocs_solve[dct]": by_basis["dct"],
            "pocs_solve[wavelet]": by_basis["wavelet"],
            "pocs_iteration": ks.pocs_iteration.launches,
            "subband_update": ksb.subband_update.launches,
            "subband_update[spatial]": ksb.subband_update_spatial.launches,
            "box_group_update": ksb.box_group_update.launches}


def reset_counts(ks, ksb):
    ks.reset_launches()
    ksb.subband_update.launches = 0
    ksb.subband_update_spatial.launches = 0
    ksb.box_group_update.launches = 0


@contextlib.contextmanager
def spatial_io():
    """``P3D_SPATIAL_IO=1`` inside the block only; the old value comes back
    however the block ends."""
    old = os.environ.get("P3D_SPATIAL_IO")
    os.environ["P3D_SPATIAL_IO"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["P3D_SPATIAL_IO"]
        else:
            os.environ["P3D_SPATIAL_IO"] = old


def cut_to_fit(torch, interpolate, Cube, truth, mask, cube, s_in, config,
               dev, label):
    """Time ``interpolate`` on the cube's first batch; when the whole cube
    would take longer than WALL_LIMIT_S, cut it to the batches that fit
    half of it (plus one slice, a last batch of 1) and print the cut.
    Returns (truth, cube, masked-input SNR) of the cube to run: ``cube``
    and ``s_in`` when nothing is cut."""
    first, _ = make_cube(torch, Cube, truth[:MAIN_BATCH], mask)
    t0 = time.perf_counter()
    interpolate(first, config=config, device=dev)
    torch.cuda.synchronize()
    per_batch = time.perf_counter() - t0
    n_batches = math.ceil(SLICES / MAIN_BATCH)
    print(f"{label} first batch of {MAIN_BATCH}: {per_batch:.2f} s",
          flush=True)
    if per_batch * n_batches <= WALL_LIMIT_S:
        return truth, cube, s_in
    slices = max(1, int(WALL_LIMIT_S / 2 / per_batch)) * MAIN_BATCH + 1
    print(f"CUT: the first batch took {per_batch:.1f} s, so the "
          f"{SLICES}-slice {label} cube would take about "
          f"{per_batch * n_batches:.0f} s; it runs {slices} slices",
          flush=True)
    cube, s_in = make_cube(torch, Cube, truth[:slices], mask)
    return truth[:slices], cube, s_in


def main_path(torch, interpolate, cube, config, dev, truth, s_in, label,
              modules, expected, default_device=False):
    """Run ``interpolate`` once with every kernel count set to 0 just
    before; check that the counts just after are ``expected`` (zero for
    every other kernel), the output and the SNR; print the wall time, the
    rate, the mean effective iterations and the device peak. ``config`` is
    a ``POCSConfig`` or a YAML-style dict; ``default_device`` leaves
    ``interpolate``'s ``device`` to its default. Returns (wall, counts,
    SNR, mean iterations, device peak in GB)."""
    f = truth.shape[0]
    niter = (config["metadata"]["niter"] if isinstance(config, dict)
             else config.niter)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(*modules)
    t0 = time.perf_counter()
    out = interpolate(cube, config=config,
                      **({} if default_device else {"device": dev}))
    wall = time.perf_counter() - t0
    counts = launch_counts(*modules)
    want = dict.fromkeys(KERNELS, 0)
    want.update(expected)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
    if counts != want:
        fail(f"{label}: kernel launches {counts} != {want} (one per batch, "
             "or per batch and iteration, for each kernel of the path)")
    rec = out.data_vars["amp_interp"][1]
    amp = cube.data_vars["amp"][1]
    if rec.shape != amp.shape:
        fail(f"{label}: output shape {rec.shape} != input {amp.shape}")
    rec = torch.from_numpy(np.moveaxis(rec, -1, 0)).to(dev)
    if not bool(torch.isfinite(rec).all()):
        fail(f"{label}: output is not finite")
    s_out = snr_db(torch, truth, rec)
    del rec
    cube_gb = f * N * N * 8 / 1e9
    iters = out.attrs["pocs_mean_iterations"]
    path = {k: v for k, v in counts.items() if v}
    print(f"{label}: {f} slices of {N}x{N} stored (iline, xline, freq), "
          f"niter {niter}, launches {path}, {wall:.2f} s wall, "
          f"{f * niter / wall:.1f} slice-iterations/s; mean "
          f"iterations {iters:.2f}; SNR {s_in:.2f} dB masked -> "
          f"{s_out:.2f} dB; device peak {peak_gb:.2f} GB = "
          f"{peak_gb / cube_gb:.2f} x the {cube_gb:.2f} GB cube pair",
          flush=True)
    if not s_out > s_in:
        fail(f"{label} did not improve SNR ({s_in:.2f} -> {s_out:.2f} dB)")
    return wall, counts, s_out, iters, peak_gb


# phase 11: the stage-2 chain on the north star's time cube
CHAIN_NS = 1024  # samples a trace: 513 rfft bins, the slices of phase 4
CHAIN_DT = 0.25e-3  # 4 kHz sampling, the sub-bottom profiler band
CHAIN_BANDPASS = [30.0, 80.0, 700.0, 1200.0]  # Hz, inside the reflectors'
CHAIN_CHECK_IL = 32  # ilines of the sub-cube held against device="cpu"
CHAIN_TOL = 1e-4  # max|card - cpu| ≤ CHAIN_TOL·max|cpu| per step
CHAIN_POST = {"upsample_factors": {"iline": 2, "xline": 2}, "footprint": {},
              "smoothing": {"kind": "gaussian", "sigma": 1},
              "agc_win": 0.05}


def reflectors(torch, il, xl, t, n_il=N, n_xl=N, seed=0):
    """Ten dipping band-limited reflectors at 0-based fractional line
    positions ``il``, ``xl`` and times ``t`` (s), float32 tensors on the
    card broadcast together: tests/test_pipeline_3d.py's ``dense_truth``
    scaled up to a 256 ms record, each reflector dipping a few ms across
    the ``n_il`` x ``n_xl`` survey."""
    rng = np.random.default_rng(seed)
    shape = torch.broadcast_shapes(il.shape, xl.shape, t.shape)
    out = torch.zeros(shape, device=t.device)
    for k in range(10):
        t0 = 0.02 + 0.021 * k
        amp = rng.uniform(0.4, 1.0) * (-1) ** k
        f0 = (300.0, 250.0, 200.0)[k % 3]
        dip_il, dip_xl = rng.uniform(-4e-3, 4e-3, size=2)
        tt = t0 + dip_il * (il / n_il) + dip_xl * (xl / n_xl)
        arg = (t - tt) * f0
        out += amp * torch.exp(-(arg * arg) * 8) * torch.cos(
            2 * math.pi * arg)
        del tt, arg
    return out


def chain_truth(torch, dev, n_il=N, n_xl=N, ns=CHAIN_NS, dt=CHAIN_DT,
                noise=0.01, seed=0):
    """(n_il, n_xl, ns) float32 time cube of the :func:`reflectors` over a
    noise floor (real records are never silent, and the AGC divides by the
    moving rms), made on the card. Returns (cube, twt)."""
    il = torch.arange(n_il, device=dev, dtype=torch.float32)[:, None, None]
    xl = torch.arange(n_xl, device=dev, dtype=torch.float32)[None, :, None]
    t = torch.arange(ns, device=dev, dtype=torch.float32)[None, None, :] * dt
    cube = reflectors(torch, il, xl, t, n_il, n_xl, seed)
    if noise:
        gen = torch.Generator(device=dev).manual_seed(seed)
        cube += noise * torch.randn(cube.shape, device=dev, generator=gen)
    return cube, np.arange(ns) * dt


def chain_fold(n_il=N, n_xl=N, seed=123, keep=0.5) -> np.ndarray:
    """About half the ilines, chosen irregularly from ``seed`` (the first
    and last kept): the decimation POCS is for."""
    rng = np.random.default_rng(seed)
    rows = {0, n_il - 1} | set(int(i) for i in rng.choice(
        n_il, size=int(n_il * keep), replace=False))
    fold = np.zeros((n_il, n_xl), np.int32)
    fold[sorted(rows)] = 1
    return fold


def time_cube(Cube, amp, fold, twt):
    n_il, n_xl = amp.shape[:2]
    return Cube(coords={"iline": np.arange(n_il), "xline": np.arange(n_xl),
                        "twt": np.asarray(twt, np.float64)},
                data_vars={"amp": (("iline", "xline", "twt"), amp),
                           "fold": (("iline", "xline"), fold)},
                attrs={"history": "BIN;"})


def fresh(cube):
    """A cube whose dicts are new and whose arrays are shared: the steps
    replace entries of their input cube's dicts."""
    return dataclasses.replace(
        cube, coords=dict(cube.coords), data_vars=dict(cube.data_vars),
        attrs=dict(cube.attrs), var_attrs=dict(cube.var_attrs),
        coord_attrs=dict(cube.coord_attrs))


def sub_cube(Cube, cube, n):
    """The first ``n`` ilines of a cube, fresh arrays (steps change their
    cube in place)."""
    return Cube(coords={k: (v[:n] if k == "iline" else v).copy()
                        for k, v in cube.coords.items()},
                data_vars={k: (d, np.array(a[:n]))
                           for k, (d, a) in cube.data_vars.items()},
                attrs=dict(cube.attrs),
                var_attrs={k: dict(v) for k, v in cube.var_attrs.items()},
                coord_attrs=dict(cube.coord_attrs))


def stage2_chain(torch, dev, modules, trace_dir):
    """Phase 11: preprocess -> fft -> interpolate -> ifft -> postprocess on
    the 512x512x1024 time cube, in memory, through the entry points with
    ``device`` left to its default. Asserts the launches (17
    ``pocs_solve[fft]``, no other kernel), the SNR after the inverse FFT
    against the masked input's, the postprocessed cube's shape and
    finiteness, and each step on the first CHAIN_CHECK_IL ilines on the
    card against ``device="cpu"``; prints each step's wall and device
    peak and, with ``--trace``, the chain's copies and idle share."""
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.ops import metrics
    from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
    from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate
    from pseudo_3d_interpolation_torch.pipeline.postprocess import postprocess
    from pseudo_3d_interpolation_torch.pipeline.preprocess import preprocess

    pre_kw = {"balance": "rms", "filter_type": "bandpass",
              "filter_freqs": CHAIN_BANDPASS}
    truth_t, twt = chain_truth(torch, dev)
    fold = chain_fold()
    masked = (truth_t * torch.from_numpy(fold).to(dev)[..., None]).cpu(
        ).numpy()
    truth = truth_t.cpu().numpy()
    del truth_t
    # the reference of the SNRs: the dense truth through the same
    # preprocess (on live traces the same traces as the masked input's)
    truth_pp = preprocess(time_cube(Cube, truth, np.ones_like(fold), twt),
                          **pre_kw)["amp"]
    raw = time_cube(Cube, masked, fold, twt)
    raw_sub = sub_cube(Cube, raw, CHAIN_CHECK_IL)
    gb = masked.nbytes / 1e9

    steps = [("preprocess", lambda c: preprocess(c, **pre_kw)),
             ("apply_fft", apply_fft),
             ("interpolate", interpolate),
             ("apply_ifft", apply_ifft),
             ("postprocess", lambda c: postprocess(c, **CHAIN_POST))]
    torch.cuda.synchronize()
    reset_counts(*modules)
    cubes, walls, peaks = [raw], [], []
    for name, step in steps:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cubes.append(step(fresh(cubes[-1])))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peaks.append((torch.cuda.max_memory_allocated(dev) - held) / 1e9)
    counts = launch_counts(*modules)
    want = dict.fromkeys(KERNELS, 0)
    want["pocs_solve[fft]"] = math.ceil(SLICES / MAIN_BATCH)
    if counts != want:
        fail(f"stage-2 chain: kernel launches {counts} != {want}")
    for (name, _), wall, peak in zip(steps, walls, peaks):
        print(f"stage-2 chain {name}: {wall:.3f} s wall, device peak "
              f"{peak:.2f} GB = {peak / gb:.2f} x the {gb:.2f} GB time cube",
              flush=True)
    print(f"stage-2 chain: {N}x{N}x{CHAIN_NS} time cube, "
          f"{int(fold[:, 0].sum())} of {N} ilines live, launches "
          f"{ {k: v for k, v in counts.items() if v} }, total "
          f"{sum(walls):.3f} s wall", flush=True)

    pre_c, freq_c, interp_c, ifft_c, post_c = cubes[1:]
    if freq_c["freq_amp"].shape != (N, N, SLICES):
        fail(f"apply_fft gave {freq_c['freq_amp'].shape}, not "
             f"{(N, N, SLICES)}")
    s_in = float(metrics.snr(truth_pp, pre_c["amp"], device=dev))
    s_out = float(metrics.snr(truth_pp, ifft_c["amp"], device=dev))
    print(f"stage-2 chain SNR against the preprocessed truth: {s_in:.2f} dB "
          f"masked -> {s_out:.2f} dB after apply_ifft", flush=True)
    if not s_out > s_in:
        fail(f"stage-2 chain did not improve SNR ({s_in:.2f} -> "
             f"{s_out:.2f} dB)")
    out = post_c["amp"]
    if out.shape != (2 * N - 1, 2 * N - 1, CHAIN_NS):
        fail(f"postprocess gave {out.shape}, not "
             f"{(2 * N - 1, 2 * N - 1, CHAIN_NS)}")
    if not bool(torch.isfinite(torch.from_numpy(out).to(dev)).all()):
        fail("the postprocessed cube is not finite")
    del truth, truth_pp, masked

    # each step on the first ilines: the card against device="cpu"
    inputs = {"preprocess": raw_sub,
              "apply_fft": sub_cube(Cube, pre_c, CHAIN_CHECK_IL),
              "apply_ifft": sub_cube(Cube, interp_c, CHAIN_CHECK_IL),
              "postprocess": sub_cube(Cube, ifft_c, CHAIN_CHECK_IL)}
    fns = dict(steps)
    for name, src in inputs.items():
        t0 = time.perf_counter()
        on_card = fns[name](sub_cube(Cube, src, CHAIN_CHECK_IL))
        wall_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        if name == "preprocess":
            on_cpu = preprocess(sub_cube(Cube, src, CHAIN_CHECK_IL),
                                device="cpu", **pre_kw)
        elif name == "postprocess":
            on_cpu = postprocess(sub_cube(Cube, src, CHAIN_CHECK_IL),
                                 device="cpu", **CHAIN_POST)
        else:
            on_cpu = fns[name](sub_cube(Cube, src, CHAIN_CHECK_IL),
                               device="cpu")
        wall_cpu = time.perf_counter() - t0
        for var, (_, ref) in on_cpu.data_vars.items():
            got = on_card[var]
            if got.shape != ref.shape:
                fail(f"{name} {var}: card {got.shape} != cpu {ref.shape}")
            err = float(np.abs(got - ref).max())
            scale = float(np.abs(ref).max())
            print(f"stage-2 {name} on {CHAIN_CHECK_IL} ilines, {var}: "
                  f"max|card - cpu| {err:.3e} = {err / scale:.2e} "
                  f"x max|cpu| (card {wall_card:.2f} s, cpu "
                  f"{wall_cpu:.2f} s)", flush=True)
            if not err <= CHAIN_TOL * scale:
                fail(f"{name} {var} on the card is not within {CHAIN_TOL}"
                     f"·max|cpu| of device='cpu'")

    if trace_dir is not None:
        def chain():
            c = raw
            for _, step in steps:
                c = step(fresh(c))
        trace_main_path(torch, chain, trace_dir, "stage2_chain_trace")


# phase 12: the plain scan route (xla-scan), which launches no kernel
XLA_CHECK = 8  # first slices held against device="cpu" (the decimated
XLA_CHECK_CV = 4  # CURVELET: these)


def xla_scan_paths(torch, Cube, truth, mask, cube, s_in, production, dev,
                   modules, trace_dir, part, folded):
    """Phase 12: the four paths of the plain scan through
    ``interpolate`` with ``device`` left to its default, each asserting
    its route, no launch of any kernel, a finite output and an SNR better
    than the masked input's; then the first slices through the same call
    on the card and with ``device="cpu"``, the two SNRs within 0.1 dB and
    their mean effective iterations side by side. Prints each path's wall,
    rate, mean iterations and device peak beside the driver's budget
    (``fits_resident``'s rule) and, under ``--trace``, its first 64
    slices' trace. ``folded`` maps a phase to the SNR of the folded kernel
    solve of the same basis on the same cube (phases 7 and 8), which the
    scan's SNR must meet within 0.1 dB: a second implementation on the
    card. Returns each path's (wall, SNR, mean iterations, peak GB, budget
    GB)."""
    from pseudo_3d_interpolation_torch.models.pocs import (describe_route,
                                                           solver_route)
    from pseudo_3d_interpolation_torch.pipeline.pocs import (
        _production_transform, _transform_device_bytes, _transform_subbands,
        config_from_yaml, interpolate)

    prod = dataclasses.asdict(production)
    paths = [
        ("12a", "DCT, eps 1e-16", dict(prod, transform_kind="DCT",
                                       eps=1e-16), "xla-scan[dct]"),
        ("12b", "WAVELET (db4, level 3), eps 1e-16",
         dict(prod, transform_kind="WAVELET", p_min=1e-5, eps=1e-16),
         "xla-scan[wavelet]"),
        ("12c", "decimated CURVELET",
         dict(prod, transform_kind="CURVELET", p_min=1e-3, decimated=True),
         "xla-scan"),
        ("12d", "FFT, hard-percentile",
         dict(prod, thresh_op="hard-percentile", decay_kind="factors",
              p_max=99.9, p_min=60.0), "xla-scan[fft]"),
    ]
    results = {}
    for phase, label, meta, want_route in paths:
        t_phase = time.perf_counter()
        if torch.backends.cuda.matmul.allow_tf32:
            fail(f"phase {phase}: torch.backends.cuda.matmul.allow_tf32 is "
                 "True: the scan's products would not be full fp32")
        config = {"metadata": meta}
        cfg, extra = config_from_yaml(config)
        tr = _production_transform(cfg, extra)
        route = describe_route(solver_route((MAIN_BATCH, N, N), (N, N), cfg,
                                            tr))
        if route.split(" ")[0] != want_route:
            fail(f"phase {phase} ({label}) takes {route}, not {want_route}")
        print(f"phase {phase}, {label}: solver path {route}; {tr}",
              flush=True)
        p_truth, p_cube, p_in = truth, cube, s_in
        if phase == "12c":
            p_truth, p_cube, p_in = cut_to_fit(
                torch, interpolate, Cube, truth, mask, cube, s_in, config,
                dev, "decimated CURVELET")
        f = p_truth.shape[0]
        wall, _, snr, iters, peak = main_path(
            torch, interpolate, p_cube, config, dev, p_truth, p_in,
            f"{label} main path ({route.split(' ')[0]})", modules, {},
            default_device=True)
        budget = ((3 * f + 8 * MAIN_BATCH * _transform_subbands(tr, (N, N),
                                                                cfg))
                  * N * N * 8
                  + _transform_device_bytes(tr, MAIN_BATCH, N, N)) / 1e9
        if phase in folded:
            print(f"phase {phase}: SNR {snr:.3f} dB, the folded kernel "
                  f"solve of the same basis {folded[phase]:.3f} dB",
                  flush=True)
            if abs(snr - folded[phase]) > SNR_TOL_DB:
                fail(f"phase {phase}: the scan's SNR {snr:.3f} dB is not "
                     f"within {SNR_TOL_DB} dB of the folded kernel solve's "
                     f"{folded[phase]:.3f} dB")
        print(f"phase {phase}: device peak {peak:.2f} GB against the "
              f"driver's budget {budget:.2f} GB ({budget / peak:.2f} x)",
              flush=True)
        del p_cube
        # the first slices on the card and on the host
        n = XLA_CHECK_CV if phase == "12c" else XLA_CHECK
        first, _ = make_cube(torch, Cube, truth[:n], mask)
        snrs, its, walls = [], [], []
        for where in (None, "cpu"):
            t0 = time.perf_counter()
            out = interpolate(first, config=config, device=where)
            walls.append(time.perf_counter() - t0)
            rec = out.data_vars["amp_interp"][1]
            snrs.append(snr_db(torch, truth[:n], torch.from_numpy(
                np.moveaxis(rec, -1, 0)).to(dev)))
            its.append(out.attrs["pocs_mean_iterations"])
        print(f"phase {phase}, first {n} slices: SNR on the card "
              f"{snrs[0]:.3f} dB, device='cpu' {snrs[1]:.3f} dB; mean "
              f"iterations {its[0]:.2f} / {its[1]:.2f} (card {walls[0]:.2f} "
              f"s, cpu {walls[1]:.2f} s)", flush=True)
        if abs(snrs[0] - snrs[1]) > SNR_TOL_DB:
            fail(f"phase {phase}: the card's SNR {snrs[0]:.3f} dB is not "
                 f"within {SNR_TOL_DB} dB of device='cpu''s {snrs[1]:.3f} dB")
        if trace_dir is not None:
            trace_main_path(torch, lambda: interpolate(part, config=config),
                            trace_dir, f"xla_scan_{phase}_trace")
        results[phase] = (wall, snr, iters, peak, budget)
        print(f"phase {phase}: {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    return results


# phase 13: SEG-Y in, SEG-Y out (workflow steps 10-16) on the card
SURVEY_TRACES = 2048  # 2.5 m apart along the xline axis: ~4 a live bin
SURVEY_STEP = 2.5  # m between traces
SURVEY_NS = 896  # samples a trace, 224 ms
SURVEY_DT_US = 250
SURVEY_DELAYS_MS = 33  # DelayRecordingTime steps over 0..32 ms by profile
BIN_SPACING = 10.0  # examples/pipeline.yml:15-18: 10 m bins over 5120 m
BIN_EXTENT = (0.0, 5120.0, 0.0, 5120.0)
MEDIAN_ILINES = 64  # 13b stacks the median of the profiles on these
BIN_TOL = 1e-5  # average: max|card - cpu| ≤ BIN_TOL·max|cpu|
MEDIAN_TOL = 1e-6
SEGY_CHAIN_PRE = {"balance": "rms"}  # examples/pipeline.yml's steps 11-15
SEGY_CHAIN_POST = {"agc_win": 0.05}


def write_survey(torch, dev, directory: pathlib.Path, ilines, seed=0):
    """One SEG-Y profile (format 5, coordinates in cm with
    ``SourceGroupScalar`` -100) along the xline axis of the BIN_EXTENT
    grid on each of the 0-based ``ilines``, x within 4 m of the iline's
    center and y every SURVEY_STEP m within 2 m, the delay of the p-th
    profile p % 33 ms: phase 11's
    :func:`reflectors` sampled at each trace's stored coordinates and
    recording times, with 1% noise, made on the card from ``seed``.
    Returns the paths and the seconds spent in ``write_segy``."""
    from pseudo_3d_interpolation_torch.io.segy import write_segy

    rng = np.random.default_rng(seed + 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = SURVEY_DT_US * 1e-6
    t_rel = torch.arange(SURVEY_NS, device=dev, dtype=torch.float32) * dt
    files, t_write = [], 0.0
    for p, il in enumerate(ilines):
        x = BIN_SPACING * (il + 0.5) + rng.uniform(-4, 4, SURVEY_TRACES)
        y = np.clip(SURVEY_STEP * (np.arange(SURVEY_TRACES) + 0.5)
                    + rng.uniform(-2, 2, SURVEY_TRACES),
                    0.0, BIN_EXTENT[3] - 0.01)
        x_cm, y_cm = np.rint(x * 100).astype(np.int64), np.rint(
            y * 100).astype(np.int64)
        delay_ms = p % SURVEY_DELAYS_MS

        def line(v_cm):  # 0-based fractional line position
            return torch.from_numpy(v_cm / 100 / BIN_SPACING - 0.5).to(
                dev, torch.float32)[:, None]

        data = reflectors(torch, line(x_cm), line(y_cm),
                          t_rel[None, :] + delay_ms * 1e-3)
        data += 0.01 * torch.randn(data.shape, device=dev, generator=gen)
        path = directory / f"profile_il{il:03d}.sgy"
        host = data.cpu().numpy()
        t0 = time.perf_counter()
        write_segy(str(path), host, fmt=5, dt_us=SURVEY_DT_US, headers={
            "SourceX": x_cm, "SourceY": y_cm, "SourceGroupScalar": -100,
            "CoordinateUnits": 1, "DelayRecordingTime": delay_ms})
        t_write += time.perf_counter() - t0
        files.append(str(path))
    return files, t_write


def assigned_fold(files, geometry) -> np.ndarray:
    """(n_il, n_xl) host ``np.bincount`` of the bins the geometry assigns
    the stored coordinates of every trace of ``files``
    (``assign_bins_indexed``, as ``bin_cube`` assigns them)."""
    from pseudo_3d_interpolation_torch.io.headers import scale_coordinates
    from pseudo_3d_interpolation_torch.io.segy import SegyFile
    from pseudo_3d_interpolation_torch.ops import binning as bn

    t, il_idx, xl_idx = geometry.transforms()
    n_il, n_xl = len(il_idx), len(xl_idx)
    fold = np.zeros(n_il * n_xl, np.int64)
    for path in files:
        with SegyFile(path) as f:
            x, y, _ = scale_coordinates(f)
        pi, px, valid = bn.assign_bins_indexed(x, y, t, il_idx, xl_idx)
        fold += np.bincount((pi.astype(np.int64) * n_xl + px)[valid],
                            minlength=n_il * n_xl)
    return fold.reshape(n_il, n_xl)


def timed(torch, dev, fn):
    """(result, wall s, device peak GB above what was held) of ``fn()``."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, (torch.cuda.max_memory_allocated(dev) - held) / 1e9


def card_against_cpu(label, card, cpu, tol):
    """Fold equal and amp within ``tol``·max|cpu| of two binned cubes."""
    if not np.array_equal(card["fold"], cpu["fold"]):
        fail(f"{label}: fold on the card differs from device='cpu'")
    err = float(np.abs(card["amp"] - cpu["amp"]).max())
    scale = float(np.abs(cpu["amp"]).max())
    print(f"{label}: max|card - cpu| {err:.3e} = {err / scale:.2e} x "
          f"max|cpu|, fold equal", flush=True)
    if not err <= tol * scale:
        fail(f"{label}: amp on the card is not within {tol}·max|cpu| of "
             "device='cpu'")


def segy_in_segy_out(torch, dev, modules, trace_dir):
    """Phase 13: SEG-Y profiles binned on the card (13a, average; 13b,
    median on the first MEDIAN_ILINES ilines), the binned cube through
    stage 2 in memory and out as a SEG-Y cube (13c), every entry point
    with ``device`` left to its default. Asserts fold against a host
    bincount, each binning against ``device='cpu'``, the launches (17
    ``pocs_solve[fft]``, no other kernel), the SNR after ``apply_ifft``
    against the truth on the grid, and the exported file read back."""
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.io.segy import SegyFile
    from pseudo_3d_interpolation_torch.ops import metrics
    from pseudo_3d_interpolation_torch.pipeline.binning import (
        BinningGeometry, bin_cube)
    from pseudo_3d_interpolation_torch.pipeline.export import cube_to_segy
    from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
    from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate
    from pseudo_3d_interpolation_torch.pipeline.postprocess import postprocess
    from pseudo_3d_interpolation_torch.pipeline.preprocess import preprocess

    # the profiles lie on phase 11's live ilines: irregular, as POCS needs
    ilines = np.flatnonzero(chain_fold(N, N)[:, 0])
    n_traces = len(ilines) * SURVEY_TRACES
    with tempfile.TemporaryDirectory(prefix="p3d_segy_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "survey").mkdir()
        t0 = time.perf_counter()
        files, t_write = write_survey(torch, dev, tmp / "survey", ilines)
        gb_in = n_traces * SURVEY_NS * 4 / 1e9
        print(f"phase 13 survey: {len(ilines)} profiles x "
              f"{SURVEY_TRACES} traces x {SURVEY_NS} samples at "
              f"{SURVEY_DT_US} us, delays 0-{SURVEY_DELAYS_MS - 1} ms: "
              f"{n_traces} traces, {gb_in:.2f} GB of samples; write_segy "
              f"{t_write:.2f} s, made and written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        # 13a: the average stack on the card against the host
        geom = BinningGeometry(spacing=BIN_SPACING, extent=BIN_EXTENT,
                               stacking_method="average")
        reset_counts(*modules)
        binned, wall, peak = timed(
            torch, dev, lambda: bin_cube(str(tmp / "survey"), geom))
        counts = launch_counts(*modules)
        if any(counts.values()):
            fail(f"bin_cube launched kernels: {counts}")
        n_il, n_xl, ns = binned["amp"].shape
        if (n_il, n_xl, ns) != (N, N, CHAIN_NS):
            fail(f"bin_cube gave {binned['amp'].shape}, not "
                 f"{(N, N, CHAIN_NS)}")
        fold = assigned_fold(files, geom)
        if not np.array_equal(binned["fold"], fold):
            fail("bin_cube's fold differs from a host bincount of the "
                 "assigned bins")
        live = binned["fold"][binned["fold"] > 0]
        print(f"13a bin_cube (average, device default): {wall:.3f} s wall, "
              f"{n_traces / wall:.0f} traces/s, {gb_in / wall:.2f} GB/s of "
              f"samples read, device peak {peak:.3f} GB; coverage "
              f"{binned.attrs['coverage']:.4f}, fold {live.min()}-"
              f"{live.max()} (mean {live.mean():.2f}) on live bins",
              flush=True)
        cpu, wall_cpu, _ = timed(torch, dev, lambda: bin_cube(
            str(tmp / "survey"), geom, device="cpu"))
        print(f"13a bin_cube on the host (device='cpu'): {wall_cpu:.3f} s",
              flush=True)
        card_against_cpu("13a average", binned, cpu, BIN_TOL)
        del cpu
        if trace_dir is not None:
            trace_main_path(torch, lambda: bin_cube(str(tmp / "survey"),
                                                    geom),
                            trace_dir, "bin_cube_trace")

        # 13b: the median of the profiles on the first ilines
        few = [f for f, il in zip(files, ilines) if il < MEDIAN_ILINES]
        med = BinningGeometry(spacing=BIN_SPACING, extent=BIN_EXTENT,
                              stacking_method="median")
        card, wall_m, peak_m = timed(torch, dev, lambda: bin_cube(few, med))
        cpu, wall_mc, _ = timed(torch, dev,
                                lambda: bin_cube(few, med, device="cpu"))
        print(f"13b bin_cube (median, {len(few)} profiles): card "
              f"{wall_m:.3f} s, device peak {peak_m:.3f} GB; host "
              f"{wall_mc:.3f} s", flush=True)
        if not np.array_equal(card["fold"], assigned_fold(few, med)):
            fail("the median's fold differs from a host bincount")
        card_against_cpu("13b median", card, cpu, MEDIAN_TOL)
        del card, cpu

        # 13c: stage 2 in memory, then the cube out as SEG-Y
        twt = binned.coords["twt"]
        il = torch.arange(N, device=dev, dtype=torch.float32)[:, None, None]
        xl = torch.arange(N, device=dev, dtype=torch.float32)[None, :, None]
        t = torch.from_numpy(twt).to(dev, torch.float32)[None, None, :]
        truth = reflectors(torch, il, xl, t).cpu().numpy()
        truth_pp = preprocess(time_cube(Cube, truth, np.ones_like(fold),
                                        twt), **SEGY_CHAIN_PRE)["amp"]
        del truth
        steps = [("preprocess", lambda c: preprocess(c, **SEGY_CHAIN_PRE)),
                 ("apply_fft", apply_fft), ("interpolate", interpolate),
                 ("apply_ifft", apply_ifft),
                 ("postprocess", lambda c: postprocess(c, **SEGY_CHAIN_POST))]
        reset_counts(*modules)
        cubes, walls = [binned], [wall]
        for name, step in steps:
            out, w, pk = timed(torch, dev, lambda: step(fresh(cubes[-1])))
            cubes.append(out)
            walls.append(w)
            print(f"13c {name}: {w:.3f} s wall, device peak {pk:.2f} GB",
                  flush=True)
        counts = launch_counts(*modules)
        want = dict.fromkeys(KERNELS, 0)
        want["pocs_solve[fft]"] = math.ceil(SLICES / MAIN_BATCH)
        if counts != want:
            fail(f"13c chain: kernel launches {counts} != {want}")
        pre_c, ifft_c, post_c = cubes[1], cubes[4], cubes[5]
        s_in = float(metrics.snr(truth_pp, pre_c["amp"], device=dev))
        s_out = float(metrics.snr(truth_pp, ifft_c["amp"], device=dev))
        print(f"13c SNR against the preprocessed truth on the grid: "
              f"{s_in:.2f} dB binned -> {s_out:.2f} dB after apply_ifft",
              flush=True)
        if not s_out > s_in:
            fail(f"13c did not improve SNR ({s_in:.2f} -> {s_out:.2f} dB)")
        del truth_pp, cubes
        out_path = str(tmp / "cube.sgy")
        _, w_exp, _ = timed(torch, dev,
                            lambda: cube_to_segy(post_c, out_path))
        walls.append(w_exp)
        amp = post_c["amp"]
        with SegyFile(out_path) as f:
            if f.n_traces != N * N or f.n_samples != CHAIN_NS:
                fail(f"the exported SEG-Y holds {f.n_traces} traces of "
                     f"{f.n_samples} samples")
            il_hdr = np.repeat(post_c.coords["iline"], N)
            xl_hdr = np.tile(post_c.coords["xline"], N)
            checks = {
                "INLINE_3D": np.array_equal(f.header("INLINE_3D"), il_hdr),
                "CROSSLINE_3D": np.array_equal(f.header("CROSSLINE_3D"),
                                               xl_hdr),
                "NStackedTraces": np.array_equal(
                    f.header("NStackedTraces"), fold.reshape(-1)),
                "dt": f.dt_us == SURVEY_DT_US,
                "DelayRecordingTime": bool(
                    (f.header("DelayRecordingTime")
                     == round(float(twt[0]) * 1e3)).all()),
                "samples": np.array_equal(f.trace_data(),
                                          amp.reshape(N * N, CHAIN_NS)),
            }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"the exported SEG-Y read back wrong: {bad}")
        print(f"13c cube_to_segy: {w_exp:.3f} s wall, "
              f"{os.path.getsize(out_path) / 1e9:.2f} GB; read back: "
              f"{N * N} traces, {', '.join(checks)} equal", flush=True)
        print(f"13 SEG-Y in, SEG-Y out: bin_cube {walls[0]:.3f} s + "
              + " + ".join(f"{n} {w:.3f} s" for (n, _), w in
                           zip(steps, walls[1:]))
              + f" + cube_to_segy {w_exp:.3f} s = {sum(walls):.3f} s wall",
              flush=True)


# phase 14: the cube drivers and the out-of-core passes
POST14 = {"upsample_factors": {"iline": 2, "xline": 2}, "footprint": {},
          "smoothing": {"kind": "gaussian", "sigma": 1,
                        "rescale_percentiles": [2, 98]},
          "agc_win": 0.05}
STREAM_TOL = 1e-6  # max|slabs - in memory| ≤ STREAM_TOL·max|in memory|
PAD_SIDE = 500  # 14d: a side 128 does not divide, padded to 512
PAD_CHECK = 4  # 14d: first slices held against device="cpu"


def expect_counts(modules, label, expected):
    """Fail unless the launch counts since the last reset are
    ``expected`` (zero for every other kernel)."""
    counts = launch_counts(*modules)
    want = dict.fromkeys(KERNELS, 0)
    want.update(expected)
    if counts != want:
        fail(f"{label}: kernel launches {counts} != {want}")
    return {k: v for k, v in counts.items() if v}


def held_equal(label, got, want, tol=STREAM_TOL):
    """Fail unless ``got`` is within ``tol``·max|want| of ``want``; print
    the difference (or that the two are bit-equal)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        fail(f"{label}: shape {got.shape} != {want.shape}")
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"{label}: " + ("bit-equal" if err == 0 else
                          f"max|Δ| {err:.3e} = {err / scale:.2e} x max"),
          flush=True)
    if not err <= tol * scale:
        fail(f"{label}: not within {tol}·max of the reference")


def drivers(torch, dev, modules, production, truth, mask, cube, wall_fft,
            sh_cube, trace_dir):
    """Phase 14a-d: ``warmup``, ``pocs_interpolate_scanned``, the
    host-chunked driver against the resident one, and ``pad_to_tile``."""
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx
    from pseudo_3d_interpolation_torch.parallel import solver
    from pseudo_3d_interpolation_torch.pipeline.pocs import (
        _production_transform, interpolate, warmup)

    shearlet = dataclasses.replace(production, transform_kind="SHEARLET")
    n_batches = math.ceil(SLICES / MAIN_BATCH)
    # 14a: one launch of the driver a production cube takes
    for config, want in ((production, {"pocs_solve[fft]": 1}),
                         (shearlet, {"subband_update": NITER,
                                     "box_group_update": 2 * NITER})):
        reset_counts(*modules)
        wall = warmup(config, (N, N), n_slices=SLICES)
        path = expect_counts(modules, "14a warmup", want)
        print(f"14a warmup {config.transform_kind} ({N}, {N}), {SLICES} "
              f"slices: {wall:.3f} s wall, launches {path}", flush=True)

    # 14b: the whole cube on the card, scanned batch by batch
    tr = _production_transform(production, {})
    obs = truth * mask
    pad = n_batches * MAIN_BATCH - SLICES
    z = Cplx(torch.cat([obs.real, obs.real.new_zeros((pad, N, N))]),
             torch.cat([obs.imag, obs.imag.new_zeros((pad, N, N))]))
    del obs
    reset_counts(*modules)
    (rec, iters, _), wall_s, peak_s = timed(
        torch, dev, lambda: solver.pocs_interpolate_scanned(
            z, mask, tr, production, batch=MAIN_BATCH))
    expect_counts(modules, "14b scanned", {"pocs_solve[fft]": n_batches})
    del z
    moved = np.moveaxis(cube.data_vars["amp"][1], -1, 0)
    mask_np = cube.data_vars["fold"][1].astype(np.float32)
    reset_counts(*modules)
    (res, wall_r, peak_r) = timed(
        torch, dev, lambda: solver.interpolate_cube_resident(
            moved, mask_np, production, transform=tr, batch=MAIN_BATCH))
    expect_counts(modules, "14b resident", {"pocs_solve[fft]": n_batches})
    print(f"14b pocs_interpolate_scanned {SLICES}+{pad} zero slices on the "
          f"card: {wall_s:.3f} s, peak {peak_s:.2f} GB; resident driver "
          f"(numpy in and out) {wall_r:.3f} s, peak {peak_r:.2f} GB",
          flush=True)
    if iters[:SLICES].cpu().numpy().tolist() != res[1].tolist():
        fail("14b: scanned iteration counts differ from the resident "
             "driver's")
    held_equal("14b scanned against resident",
               torch.complex(rec.re[:SLICES], rec.im[:SLICES]).cpu().numpy(),
               res[0])
    del rec, iters

    # 14c: the host-chunked driver against the resident one
    sh_moved = np.moveaxis(sh_cube.data_vars["amp"][1], -1, 0)
    sh_tr = _production_transform(shearlet, {})
    for label, config, transform, data, want in (
            ("FFT", production, tr, moved, {"pocs_solve[fft]": n_batches}),
            ("SHEARLET", shearlet, sh_tr, sh_moved, None)):
        nb = math.ceil(data.shape[0] / MAIN_BATCH)
        want = want or {"subband_update": nb * NITER,
                        "box_group_update": 2 * nb * NITER}
        out = {}
        for name, driver in (("resident", solver.interpolate_cube_resident),
                             ("host-chunked", solver.interpolate_cube)):
            reset_counts(*modules)
            out[name] = timed(torch, dev, lambda: driver(
                data, mask_np, config, transform=transform,
                batch=MAIN_BATCH))
            expect_counts(modules, f"14c {label} {name}", want)
        (r_res, w_res, p_res), (r_hc, w_hc, p_hc) = (out["resident"],
                                                     out["host-chunked"])
        print(f"14c {label} {data.shape[0]} slices, batch {MAIN_BATCH}: "
              f"resident {w_res:.3f} s, peak {p_res:.2f} GB; host-chunked "
              f"{w_hc:.3f} s, peak {p_hc:.2f} GB", flush=True)
        if r_res[1].tolist() != r_hc[1].tolist():
            fail(f"14c {label}: iteration counts differ between drivers")
        held_equal(f"14c {label} host-chunked against resident", r_hc[0],
                   r_res[0])
        if trace_dir is not None:
            trace_main_path(torch, lambda: solver.interpolate_cube(
                data[:2 * MAIN_BATCH], mask_np, config, transform=transform,
                batch=MAIN_BATCH), trace_dir,
                f"host_chunked_{label.lower()}_trace")
        del out, r_res, r_hc

    # 14d: pad_to_tile on a 500x500 cut of the FFT cube
    s = PAD_SIDE
    cut = Cube(coords={"iline": np.arange(s), "xline": np.arange(s),
                       "freq": np.arange(SLICES, dtype=np.float64)},
               data_vars={"amp": (("iline", "xline", "freq"),
                                  np.ascontiguousarray(
                                      cube.data_vars["amp"][1][:s, :s])),
                          "fold": (("iline", "xline"),
                                   cube.data_vars["fold"][1][:s, :s])})
    truth_cut = truth[:, :s, :s]
    walls, snrs = {}, {}
    for pad_to_tile in (True, None):
        config = dataclasses.replace(production, pad_to_tile=pad_to_tile)
        reset_counts(*modules)
        t0 = time.perf_counter()
        rec = interpolate(cut, config=config)
        walls[pad_to_tile] = time.perf_counter() - t0
        expect_counts(modules, f"14d pad_to_tile={pad_to_tile}",
                      {"pocs_solve[fft]": n_batches})
        rec = rec.data_vars["amp_interp"][1]
        if rec.shape != (s, s, SLICES):
            fail(f"14d: pad_to_tile={pad_to_tile} gave {rec.shape}")
        snrs[pad_to_tile] = snr_db(torch, truth_cut, torch.from_numpy(
            np.moveaxis(rec, -1, 0)).to(dev))
    side = -(-s // 128) * 128
    print(f"14d {s}x{s}x{SLICES} FFT cube: pad_to_tile=True (solved at "
          f"{side}x{side}) {walls[True]:.3f} s, SNR {snrs[True]:.2f} dB; None "
          f"(solved at {s}x{s}) {walls[None]:.3f} s, SNR {snrs[None]:.2f} "
          f"dB; phase 4's 512x512 cube {wall_fft:.3f} s", flush=True)
    first = Cube(coords={**cut.coords,
                         "freq": cut.coords["freq"][:PAD_CHECK]},
                 data_vars={"amp": (("iline", "xline", "freq"), np.array(
                     cut.data_vars["amp"][1][..., :PAD_CHECK])),
                     "fold": cut.data_vars["fold"]})
    padded = dataclasses.replace(production, pad_to_tile=True)
    snr_first = []
    for where in (dev, "cpu"):
        rec = interpolate(first, config=padded, device=where)
        snr_first.append(snr_db(torch, truth_cut[:PAD_CHECK], torch.from_numpy(
            np.moveaxis(rec.data_vars["amp_interp"][1], -1, 0)).to(dev)))
    print(f"14d padded, first {PAD_CHECK} slices: SNR on the card "
          f"{snr_first[0]:.3f} dB, device='cpu' {snr_first[1]:.3f} dB",
          flush=True)
    if abs(snr_first[0] - snr_first[1]) > SNR_TOL_DB:
        fail("14d: the padded solve on the card is not within "
             f"{SNR_TOL_DB} dB of device='cpu'")


def streamed_passes(torch, dev, modules, trace_dir):
    """Phase 14e: the streamed preprocess and postprocess slab loops over
    phase 11's time cube from an in-memory source into an in-memory
    sink, each against the in-memory step on the card; and
    ``streamed_percentiles`` of card blocks against numpy on the host."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "tests"))
    from torch_helpers import MemoryCube, MemoryStore

    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.pipeline import postprocess as post
    from pseudo_3d_interpolation_torch.pipeline import preprocess as pre

    pre_kw = {"balance": "rms", "filter_type": "bandpass",
              "filter_freqs": CHAIN_BANDPASS}
    truth_t, twt = chain_truth(torch, dev)
    fold = chain_fold()
    masked = (truth_t * torch.from_numpy(fold).to(dev)[..., None]).cpu(
        ).numpy()
    del truth_t
    raw = time_cube(Cube, masked, fold, twt)
    gb = masked.nbytes / 1e9

    def against_memory(name, step, slabs, cube):
        """``slabs`` from an in-memory source into an in-memory sink
        against ``step`` in memory, on the card; returns the latter."""
        reset_counts(*modules)
        ram, w_ram, p_ram = timed(torch, dev, lambda: step(fresh(cube)))
        store = MemoryStore()
        src = MemoryCube.from_cube(cube)
        _, w_st, p_st = timed(torch, dev, lambda: slabs(src, store))
        expect_counts(modules, f"14e {name}", {})
        moved = src.bytes_read + store.bytes_moved()
        out = store.final.to_cube()
        print(f"14e {name} of the {gb:.2f} GB time cube: in memory "
              f"{w_ram:.3f} s, peak {p_ram:.2f} GB; slab loop {w_st:.3f} "
              f"s, peak {p_st:.2f} GB, {moved / 1e9:.2f} GB read and "
              f"written by the source and sink", flush=True)
        for var, (_, want) in ram.data_vars.items():
            held_equal(f"14e {name} {var}, slabs against in memory",
                       out[var], want)
        del out, store, src
        if trace_dir is not None:
            trace_main_path(torch, lambda: slabs(MemoryCube.from_cube(cube),
                                                 MemoryStore()),
                            trace_dir, f"streamed_{name}_trace")
        return ram

    ram_pre = against_memory(
        "preprocess", lambda c: pre.preprocess(c, **pre_kw),
        lambda src, st: pre.preprocess_slabs(src, st, "amp", **pre_kw), raw)
    del raw, masked
    against_memory(
        "postprocess", lambda c: post.postprocess(c, **POST14),
        lambda src, st: post.postprocess_slabs(src, st, "amp", **POST14),
        ram_pre)

    # streamed_percentiles of blocks on the card against numpy on the host
    amp = ram_pre["amp"]
    qs = [0.5, 2, 50, 98, 99.5]

    def blocks():
        for i in range(0, amp.shape[0], 32):
            yield torch.from_numpy(amp[i:i + 32]).to(dev)
    t0 = time.perf_counter()
    got = post.streamed_percentiles(blocks, qs)
    w_sp = time.perf_counter() - t0
    want = np.percentile(amp, qs).tolist()
    print(f"14e streamed_percentiles {qs} of {amp.size} values in blocks on "
          f"the card: {w_sp:.3f} s, {got}; numpy.percentile on the host "
          f"{want}: {'exact' if got == want else 'DIFFERENT'}", flush=True)
    if got != want:
        fail("14e: streamed_percentiles on the card is not numpy's")


def file_paths(torch, dev, production, cube):
    """Phase 14f: ``interpolate_checkpointed`` and the two streamed passes
    on files in a temporary directory, against the in-memory steps; runs
    only where h5py imports (a host library)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("14f did not run: h5py is not installed here (the file "
              "paths are host code, tested on the CPU)", flush=True)
        return
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.io.ncio import read_cube, write_cube
    from pseudo_3d_interpolation_torch.pipeline import postprocess as post
    from pseudo_3d_interpolation_torch.pipeline import preprocess as pre
    from pseudo_3d_interpolation_torch.pipeline.pocs import (
        interpolate, interpolate_checkpointed)

    n = 2 * MAIN_BATCH + 1
    part = Cube(coords={**cube.coords, "freq": cube.coords["freq"][:n]},
                data_vars={"amp": (("iline", "xline", "freq"), np.array(
                    cube.data_vars["amp"][1][..., :n])),
                    "fold": cube.data_vars["fold"]})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_cube(tmp / "freq.nc", part, chunks={"freq": 1})
        t0 = time.perf_counter()
        out = interpolate_checkpointed(str(tmp / "freq.nc"), production,
                                       str(tmp / "ck"), batch=MAIN_BATCH,
                                       out_path=str(tmp / "interp.nc"))
        wall = time.perf_counter() - t0
        held_equal(f"14f interpolate_checkpointed {n} slices ({wall:.2f} "
                   "s) against interpolate",
                   read_cube(out)["amp_interp"],
                   interpolate(part, config=production)["amp_interp"])
        truth_t, twt = chain_truth(torch, dev, n_xl=128)
        fold = chain_fold(n_xl=128)
        amp = (truth_t * torch.from_numpy(fold).to(dev)[..., None]).cpu(
            ).numpy()
        del truth_t
        write_cube(tmp / "time.nc", time_cube(Cube, amp, fold, twt))
        pre_kw = {"balance": "rms", "filter_type": "bandpass",
                  "filter_freqs": CHAIN_BANDPASS}
        for name, fn, kw, src in (
                ("preprocess", pre.preprocess, pre_kw, "time.nc"),
                ("postprocess", post.postprocess, POST14, "pre.nc")):
            t0 = time.perf_counter()
            fn(str(tmp / src), out_path=str(tmp / f"{name[:3]}.nc"),
               out_of_core=True, **kw)
            wall = time.perf_counter() - t0
            held_equal(f"14f {name} streamed through files ({wall:.2f} s) "
                       "against in memory",
                       read_cube(tmp / f"{name[:3]}.nc")["amp"],
                       fn(read_cube(tmp / src), **kw)["amp"])


# phase 15: stage 1 (workflow steps 01-08) on SEG-Y profiles
STAGE1_LINES = 30  # parallel profiles, each crossed by
STAGE1_TIES = 2  # tie lines: 60 crossings
STAGE1_TRACES = 2048  # traces a profile, as phase 13's
STAGE1_NS = 896  # samples a trace at 250 us, as phase 13's
STAGE1_CPU = ("L00", "L15", "L29", "T00")  # the subset held to the host
STAGE1_CORR_TOL = 1e-6  # misties.csv correlations, card against host


def sample_bytes(files) -> int:
    from pseudo_3d_interpolation_torch.io.segy import SegyFile

    total = 0
    for p in files:
        with SegyFile(p) as f:
            total += f.n_traces * f.n_samples * 4
    return total


def stage1_survey(torch, dev, modules, trace_dir):
    """Phase 15: workflow steps 01-08 through their entry points, with
    ``device`` left to its default, on ``stage1_survey_32``: 30 parallel
    profiles and 2 tie lines crossing all of them, 2048 traces of 896
    samples at 250 us each, in WGS84 degrees, with every defect of
    ``tests/torch_helpers.write_stage1_survey`` (a short file after a
    recording gap, wrong-delay runs, tie lines on another delay, heave
    jitter, a tide CSV, a line 1 ms deep, spikes). Each step runs under
    torch.profiler for the card's busy time. Asserts no kernel launch,
    the repairs against what the survey injected
    (``check_stage1_truth``), and each device step (03, 05-08) on the
    card equal to ``device='cpu'`` on a subset of profiles (07 on a tie
    line and three lines it crosses, both runs on copies of that
    subset): headers and samples bit for bit, sidecars as numbers."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "tests"))
    from torch_helpers import (check_stage1_truth, same_csv, same_outputs,
                               stage1_steps, write_stage1_survey)

    from pseudo_3d_interpolation_torch.pipeline import stage1 as st

    with tempfile.TemporaryDirectory(prefix="p3d_stage1_") as tmp:
        tmp = pathlib.Path(tmp)
        survey = tmp / "survey"
        survey.mkdir()
        t0 = time.perf_counter()
        truth = write_stage1_survey(survey, n_lines=STAGE1_LINES,
                                    n_ties=STAGE1_TIES, ntr=STAGE1_TRACES,
                                    ns=STAGE1_NS, seed=0)
        files = sorted(str(p) for p in survey.glob("*.sgy"))
        print(f"phase 15 survey stage1_survey_32: {len(files)} files "
              f"({STAGE1_LINES} lines + {STAGE1_TIES} ties, line 0 in two), "
              f"{STAGE1_TRACES} traces x {STAGE1_NS} samples at 250 us, "
              f"{sample_bytes(files) / 1e6:.1f} MB of samples, written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        timings = {}
        steps = stage1_steps(st, truth["tide"], timings)
        # the delrt correction's moving medians: two a pass, each a round
        # trip to the card (numpy in, numpy back)
        medians = {"n": 0, "s": 0.0}
        median_f32 = st._moving_median_f32

        def counted_median(*a, **kw):
            t_m = time.perf_counter()
            out = median_f32(*a, **kw)
            medians["n"] += 1
            medians["s"] += time.perf_counter() - t_m
            return out
        outs, inputs = {}, {}
        reset_counts(*modules)
        total_wall = total_busy = 0.0
        cur = str(survey)
        for k, (name, step, _) in enumerate(steps):
            name = f"{k + 1:02d} {name}"
            inputs[name] = cur
            n_bytes = sample_bytes(
                cur if isinstance(cur, list) else files)
            st._moving_median_f32 = counted_median
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    res, wall, peak = timed(torch, dev, lambda: step(cur))
            finally:
                st._moving_median_f32 = median_f32
            raw = tmp / "trace.json"
            events = device_events(prof, raw)
            if trace_dir is not None:
                trace_dir.mkdir(parents=True, exist_ok=True)
                keep = trace_dir / f"stage1_{name.replace(' ', '_')}.json.gz"
                with open(raw, "rb") as src, gzip.open(keep, "wb") as dst:
                    dst.write(src.read())
            raw.unlink()
            busy = busy_seconds(events)
            total_wall, total_busy = total_wall + wall, total_busy + busy
            print(f"15 {name}: {wall:.3f} s wall, {n_bytes / 1e6 / wall:.1f} "
                  f"MB/s of samples, device busy {busy * 1e3:.2f} ms "
                  f"({len(events)} device events), host share (idle share "
                  f"of the traced wall) {1 - busy / wall:.4f}, device peak "
                  f"{peak:.3f} GB", flush=True)
            if name.startswith("03"):
                print(f"15 03 moving medians: {medians['n']} calls of "
                      f"{STAGE1_TRACES} values, {medians['s']:.3f} s, "
                      f"{medians['s'] / max(medians['n'], 1) * 1e6:.0f} us "
                      f"a call ({medians['s'] / wall:.3f} of the step)",
                      flush=True)
            if name.startswith("07"):
                t_x = timings["intersections"]
                print(f"15 07 intersection search (host numpy, "
                      f"{STAGE1_LINES * STAGE1_TIES} crossings): {t_x:.2f} s, "
                      f"{t_x / wall:.3f} of the step", flush=True)
            outs[name] = cur = res
        print(f"15 steps 01-08: {total_wall:.2f} s wall, device busy "
              f"{total_busy:.3f} s, host share "
              f"{1 - total_busy / total_wall:.4f}", flush=True)
        counts = launch_counts(*modules)
        if any(counts.values()):
            fail(f"stage 1 launched kernels: {counts}")
        found = check_stage1_truth(
            truth, {name.split()[1]: v for name, v in outs.items()})
        print(f"15 repairs against the survey: delays {found['delays']} "
              f"exact, picks {found['picks']} and the flattened seafloor "
              f"within a sample, tide shifts {found['tide']} exact, "
              f"the mistie line shifted {found['mistie_ms']:+.3f} ms against "
              f"the others (recorded {truth['mistie_ms']:.3f} ms deep), "
              f"{found['spikes']} spikes found and removed", flush=True)

        # each device step on the host, on a subset of its inputs
        def subset(paths):
            return [p for p in paths
                    if os.path.basename(p)[:3] in STAGE1_CPU]

        for k, (name, step, device_step) in enumerate(steps):
            name = f"{k + 1:02d} {name}"
            if not device_step:
                continue
            src = subset(inputs[name])
            if name.startswith("07"):
                runs = {}
                for where in ("card", "cpu"):
                    d = tmp / f"mistie_{where}"
                    d.mkdir()
                    for p in src:
                        shutil.copy(p, d)
                    kw = {} if where == "card" else {"device": "cpu"}
                    runs[where] = (d, step(sorted(str(d / os.path.basename(p))
                                                  for p in src), **kw))
                (d_card, card), (d_cpu, cpu) = runs["card"], runs["cpu"]
                same_outputs(card, cpu, sidecars=(".mst",))
                same_csv(d_card / "misties.csv", d_cpu / "misties.csv",
                         atol={"correlation": STAGE1_CORR_TOL})
            else:
                out_dir = tmp / f"cpu_{name.split()[0]}"
                cpu = step(src, device="cpu", output_dir=str(out_dir))
                card = subset(outs[name])
                same_outputs(card, cpu, sidecars=(".sta", ".tid"))
            print(f"15 {name}: card equal to device='cpu' on {len(src)} "
                  f"profiles (headers and samples bit for bit, sidecars "
                  f"as numbers)", flush=True)
        counts = launch_counts(*modules)
        if any(counts.values()):
            fail(f"stage 1 launched kernels: {counts}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", type=pathlib.Path, default=None,
                        metavar="DIR", help="trace each main path once more "
                        "and write the Chrome traces to DIR")
    args = parser.parse_args()
    import torch

    # phases 3-9 take the spectral route; phase 10 sets the switch itself
    os.environ.pop("P3D_SPATIAL_IO", None)

    t_start = time.perf_counter()
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    try:
        from pseudo_3d_interpolation_torch.ops import kernels  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the "
             "repository root")
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.models.pocs import (describe_route,
                                                           solver_route)
    from pseudo_3d_interpolation_torch.models.transforms import get_transform
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx
    from pseudo_3d_interpolation_torch.ops.kernels import _build
    from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
    from pseudo_3d_interpolation_torch.ops import shearlet as sh
    from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
    from pseudo_3d_interpolation_torch.pipeline.pocs import (
        _production_transform, interpolate)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    # the plain versions' complex matmuls in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"allow_tf32=False", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    libs = _build.build()
    ks._lib()
    ksb._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{sorted(p.name for p in libs.values())}", flush=True)
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                print(f"  ptxas {lib.stem[:20]}: {line.strip()}")

    # phase 3a: pocs_solve against plain, ending at the main path's shapes
    cases = [(8, N, N, op, ver, 10, "highest") for op in ("soft", "hard")
             for ver in ("regular", "fast")]
    cases += [(4, 384, N, "soft", "fast", 10, "highest"),
              (4, 384, N, "hard", "fast", 10, "highest"),
              (SLICES % MAIN_BATCH, N, N, "hard", "fast", NITER, "high"),
              (MAIN_BATCH, N, N, "hard", "fast", NITER, "high")]
    err_solve = 0.0
    for i, case in enumerate(cases):
        z, mask, tau, err = kernel_against_plain(torch, ks, Cplx, case,
                                                 100 + i, dev)
        err_solve = max(err_solve, err)
    solve_ms, solve_plain_ms, four = time_pair(
        torch, lambda: ks.pocs_solve(z, mask, tau, ALPHA, "hard", "fast",
                                     "high"),
        lambda: ks.pocs_solve_plain(z, mask, tau, ALPHA, "hard", "fast"), 2)
    print(f"pocs_solve {MAIN_BATCH}x{N}x{N}, {NITER} iterations: kernel "
          f"{four[0]:.2f} / {four[1]:.2f} ms, plain (torch.fft) "
          f"{four[2]:.2f} / {four[3]:.2f} ms", flush=True)
    solve_passes(torch, ks, z, mask, tau)
    # precision 'default' computes in full fp32, as 'high' does
    res = {p: ks.pocs_solve(z, mask, tau, ALPHA, "hard", "fast", p)
           for p in ("default", "high")}
    same = all(torch.equal(a, b) for a, b in zip(
        (*res["default"][0], res["default"][1]),
        (*res["high"][0], res["high"][1])))
    print(f"pocs_solve[fft] {MAIN_BATCH}x{N}x{N} at precision 'default': "
          f"{'bit-equal' if same else 'NOT equal'} to 'high'", flush=True)
    if not same:
        fail("pocs_solve[fft] at precision 'default' differs from 'high'")
    del res
    # the compulsory bytes of a solve: the observed pair in, the result
    # pair out, the mask, the thresholds, the costs
    solve_bytes = (MAIN_BATCH * N * N * 16 + N * N * 4
                   + NITER * MAIN_BATCH * 4 + MAIN_BATCH * 4)
    solve_bound = bound(2 * fft2_flops(N, N) * NITER * MAIN_BATCH,
                        solve_bytes)
    del z, mask, tau

    # phase 3b: the subband kernels' line engine, then the kernels,
    # against plain
    line_engine_against_plain(torch, ksb, Cplx, dev)
    err_a = err_b = 0.0
    for b, h, w, boxes in ((8, N, N, True), (4, 384, N, False)):
        case = SubbandCase(torch, b, h, w, 200 + h, dev)
        ea, eb = subband_kernels_against_plain(torch, ksb, case,
                                               ("soft", "hard"), boxes)
        err_a, err_b = max(err_a, ea), max(err_b, eb)
        del case
    case = SubbandCase(torch, MAIN_BATCH, N, N, 300, dev)
    n_full = case.psi.shape[0]
    sub_ms, sub_plain_ms, four = time_pair(
        torch, lambda: ksb.subband_update(case.spec, case.psi, case.tau_full,
                                          "hard", "high",
                                          support=case.support),
        lambda: ksb.subband_update_plain(case.spec, case.psi, case.tau_full,
                                         "hard"), 3)
    print(f"subband_update {MAIN_BATCH}x{N}x{N}, {n_full} bands: kernel "
          f"{four[0]:.2f} / {four[1]:.2f} ms, plain (torch.fft) "
          f"{four[2]:.2f} / {four[3]:.2f} ms", flush=True)
    subband_passes(torch, ksb, case, False)
    sub_bound = subband_bound("subband_update", case, False)
    box_times, box_bounds = [], []
    for k in range(len(case.boxes)):
        t_k, t_p, bnd = time_box(torch, ksb, case, k)
        box_times.append((t_k, t_p))
        box_bounds.append(bnd)
    box_ms = sum(t for t, _ in box_times) / len(box_times)
    box_plain_ms = sum(t for _, t in box_times) / len(box_times)
    box_bound = (sum(b for b, _ in box_bounds) / len(box_bounds),
                 box_bounds[0][1])
    del case

    # phase 3c: pocs_iteration against plain, ending at the main path's
    # two batch sizes
    err_iter = 0.0
    for i, (b, h, op) in enumerate(((8, N, "soft"), (8, N, "hard"),
                                    (4, 384, "soft"), (4, 384, "hard"),
                                    (SLICES % MAIN_BATCH, N, "hard"),
                                    (MAIN_BATCH, N, "hard"))):
        z, mask, tau, err = iteration_against_plain(torch, ks, Cplx, b, h, N,
                                                    op, 400 + i, dev)
        err_iter = max(err_iter, err)
    iter_ms, iter_plain_ms, four = time_pair(
        torch, lambda: ks.pocs_iteration(z, z, mask, tau, ALPHA, "hard",
                                         "high"),
        lambda: ks.pocs_iteration_plain(z, z, mask, tau, ALPHA, "hard"), 20)
    print(f"pocs_iteration {MAIN_BATCH}x{N}x{N}: kernel {four[0]:.3f} / "
          f"{four[1]:.3f} ms, plain (torch.fft) {four[2]:.3f} / "
          f"{four[3]:.3f} ms", flush=True)
    iteration_passes(torch, ks, z, mask, tau)
    # x and obs pairs in, the result pair out, the mask, the thresholds
    iter_bound = bound(2 * fft2_flops(N, N) * MAIN_BATCH,
                       MAIN_BATCH * N * N * 24 + N * N * 4 + MAIN_BATCH * 4)
    del z, mask, tau

    # phase 3d: the DCT solve against plain, ending at the main path's
    # shapes
    cases = [(8, N, N, op, ver, 10, "highest") for op in ("soft", "hard")
             for ver in ("regular", "fast")]
    cases += [(4, h, w, op, "fast", 10, "highest")
              for h, w in ((384, N), (97, 130)) for op in ("soft", "hard")]
    cases += [(SLICES % MAIN_BATCH, N, N, "hard", "fast", NITER, "high"),
              (MAIN_BATCH, N, N, "hard", "fast", NITER, "high")]
    err_dct = 0.0
    for i, case in enumerate(cases):
        z, mask, tau, err = kernel_against_plain(torch, ks, Cplx, case,
                                                 500 + i, dev, "dct")
        err_dct = max(err_dct, err)
    dct_ms, dct_plain_ms, four = time_pair(
        torch, lambda: ks.pocs_solve(z, mask, tau, ALPHA, "hard", "fast",
                                     "high", basis="dct"),
        lambda: ks.pocs_solve_plain(z, mask, tau, ALPHA, "hard", "fast",
                                    basis="dct"), 2)
    print(f"pocs_solve[dct] {MAIN_BATCH}x{N}x{N}, {NITER} iterations: "
          f"kernel {four[0]:.2f} / {four[1]:.2f} ms, plain (torch.matmul) "
          f"{four[2]:.2f} / {four[3]:.2f} ms", flush=True)
    solve_passes(torch, ks, z, mask, tau, "dct")
    # four real 2-D DCTs per slice-iteration at 2.5·n·log2 n each
    dct_bound = bound(4 * 2.5 * N * N * math.log2(N * N) * NITER
                      * MAIN_BATCH, solve_bytes)
    del z, mask, tau

    # phase 3e: the wavelet solve against plain, ending at the main path's
    # shapes
    cases = [((8, N, N, op, "fast", 10, "highest"), name)
             for name in ("db4", "coif5") for op in ("soft", "hard")]
    cases += [((SLICES % MAIN_BATCH, N, N, "hard", "fast", NITER, "high"),
               "db4"),
              ((MAIN_BATCH, N, N, "hard", "fast", NITER, "high"), "db4")]
    err_wv = 0.0
    for i, (case, name) in enumerate(cases):
        z, mask, tau, err = kernel_against_plain(torch, ks, Cplx, case,
                                                 600 + i, dev, "wavelet",
                                                 name)
        err_wv = max(err_wv, err)
    mats = wavelet_mats(N, "db4")
    wv_ms, wv_plain_ms, four = time_pair(
        torch, lambda: ks.pocs_solve(z, mask, tau, ALPHA, "hard", "fast",
                                     "high", basis="wavelet",
                                     wavelet_mats=mats),
        lambda: ks.pocs_solve_plain(z, mask, tau, ALPHA, "hard", "fast",
                                    basis="wavelet", wavelet_mats=mats), 2)
    print(f"pocs_solve[wavelet] db4 level 3 {MAIN_BATCH}x{N}x{N}, {NITER} "
          f"iterations: kernel {four[0]:.2f} / {four[1]:.2f} ms, plain "
          f"(torch.matmul) {four[2]:.2f} / {four[3]:.2f} ms", flush=True)
    wavelet_passes(torch, ks, z, mask, tau, mats)
    # db4's filter length 8: 2·8 flops per output per 1-D pass, two passes
    # per level, forward and inverse, re and im
    wv_flops = sum(16 * 8 * (N >> lv) ** 2 for lv in range(3))
    wv_bound = bound(wv_flops * NITER * MAIN_BATCH,
                     solve_bytes + NITER * MAIN_BATCH * 8 * 4)
    del z, mask, tau

    # phase 3f: the spatial subband kernel, and both subband kernels on the
    # CURVELET plan (41 full-size bands, one 72-side box group of 9),
    # against plain at the main paths' batches (32 and the cube's last 1),
    # where the bands run in chunks and only the last chunk inverts;
    # timings last
    last = SLICES % MAIN_BATCH
    for name in ("SHEARLET", "CURVELET"):
        full = sh._plan_kernel_pack(get_transform(name)._plan(N, N), N, N)[0]
        offsets = full.support_on(dev).offsets
        if len(ksb.band_chunks(offsets, MAIN_BATCH, N, N)) < 3:
            fail(f"the {name} main path's batch runs its {len(offsets) - 1} "
                 "bands in one chunk: phase 3f would not check the chunked "
                 "sum")
    err_sp = 0.0
    for i, (b, h) in enumerate(((8, N), (4, 384), (last, N),
                                (MAIN_BATCH, N))):
        sp_case = SubbandCase(torch, b, h, N, 700 + i, dev)
        ea, _ = subband_kernels_against_plain(torch, ksb, sp_case,
                                              ("soft", "hard"), False, True)
        err_sp = max(err_sp, ea)
    for i, b in enumerate((8, last, MAIN_BATCH)):
        cv_case = SubbandCase(torch, b, N, N, 710 + i, dev, "CURVELET")
        if [(lg, len(g.idx_h)) for _, lg, g in cv_case.boxes] != [(9, 72)]:
            fail("the 512² CURVELET plan packs no 72-side box group of 9 "
                 "bands")
        ea, eb = subband_kernels_against_plain(torch, ksb, cv_case,
                                               ("soft", "hard"), True)
        es, _ = subband_kernels_against_plain(torch, ksb, cv_case,
                                              ("soft", "hard"), False, True)
        err_a, err_b, err_sp = max(err_a, ea), max(err_b, eb), max(err_sp, es)
    case = sp_case
    sp_ms, sp_plain_ms, four = time_pair(
        torch, lambda: ksb.subband_update_spatial(case.x, case.psi,
                                                  case.tau_full, "hard",
                                                  "high",
                                                  support=case.support),
        lambda: ksb.subband_update_spatial_plain(case.x, case.psi,
                                                 case.tau_full, "hard"), 3)
    print(f"subband_update_spatial {MAIN_BATCH}x{N}x{N}, {n_full} bands: "
          f"kernel {four[0]:.2f} / {four[1]:.2f} ms, plain (torch.fft) "
          f"{four[2]:.2f} / {four[3]:.2f} ms", flush=True)
    subband_passes(torch, ksb, case, True)
    sp_bound = subband_bound("subband_update_spatial", case, True)
    subband_passes(torch, ksb, cv_case, False)
    subband_bound("subband_update (CURVELET)", cv_case, False)
    time_box(torch, ksb, cv_case, 0)
    del case, sp_case, cv_case
    torch.cuda.empty_cache()
    print(f"phases 1-3: {time.perf_counter() - t_start:.1f} s", flush=True)

    # phase 4: the FFT main path, on a cube stored (iline, xline, freq)
    modules = (ks, ksb)
    production = inspect.signature(interpolate).parameters["config"].default
    truth, mask = plane_waves(torch, SLICES, N, N, 0, dev)
    cube, s_in = make_cube(torch, Cube, truth, mask)
    n_batches = math.ceil(SLICES / MAIN_BATCH)
    wall_fft, counts_fft, snr_fft, _, _ = main_path(
        torch, interpolate, cube, production, dev, truth, s_in,
        "FFT main path", modules, {"pocs_solve[fft]": n_batches})
    if args.trace is not None:
        trace_main_path(torch, lambda: interpolate(cube, config=production,
                                                   device=dev),
                        args.trace, "fft_main_path_trace")

    # phase 5: the SHEARLET main path on the same cube
    shearlet = dataclasses.replace(production, transform_kind="SHEARLET")
    sh_truth, sh_cube, sh_in = cut_to_fit(torch, interpolate, Cube, truth,
                                          mask, cube, s_in, shearlet, dev,
                                          "SHEARLET")
    sh_batches = math.ceil(sh_truth.shape[0] / MAIN_BATCH)
    _, counts_sh, snr_sh, _, _ = main_path(
        torch, interpolate, sh_cube, shearlet, dev, sh_truth, sh_in,
        "SHEARLET main path", modules,
        {"subband_update": sh_batches * NITER,
         "box_group_update": 2 * sh_batches * NITER})
    part, _ = make_cube(torch, Cube, truth[:2 * MAIN_BATCH], mask)
    if args.trace is not None:
        trace_main_path(torch, lambda: interpolate(part, config=shearlet,
                                                   device=dev),
                        args.trace, "shearlet_main_path_trace")

    # phase 6: the FFT basis with the reference's recommended eps = 1e-16,
    # through the scan over pocs_iteration
    recommended = dataclasses.replace(production, eps=1e-16)
    route = solver_route((MAIN_BATCH, N, N), (N, N), recommended,
                         get_transform("FFT"))
    if describe_route(route).split(" ")[0] != "fused-periter[fft]":
        fail(f"the recommended configuration takes {describe_route(route)}"
             ", not fused-periter[fft]")
    _, counts_it, snr_it, iters_it, _ = main_path(
        torch, interpolate, cube, recommended, dev, truth, s_in,
        "FFT per-iteration main path (eps 1e-16)", modules,
        {"pocs_iteration": n_batches * NITER})
    print(f"recommended configuration (eps 1e-16, fused-periter[fft]): "
          f"mean iterations {iters_it:.2f}, SNR {snr_it:.2f} dB; production "
          f"defaults (eps 0, fused-folded[fft], phase 4): {NITER} "
          f"iterations, SNR {snr_fft:.2f} dB", flush=True)
    # the path ends at the float32 floor, where the SNR measures rounding:
    # the first batch on the card and through the plain versions on the host
    first, _ = make_cube(torch, Cube, truth[:MAIN_BATCH], mask)
    snr_first = []
    for where in (dev, "cpu"):
        rec = interpolate(first, config=recommended,
                          device=where).data_vars["amp_interp"][1]
        snr_first.append(snr_db(torch, truth[:MAIN_BATCH], torch.from_numpy(
            np.moveaxis(rec, -1, 0)).to(dev)))
    print(f"per-iteration path, first batch of {MAIN_BATCH}: SNR on the card "
          f"{snr_first[0]:.2f} dB, plain versions on the host "
          f"{snr_first[1]:.2f} dB", flush=True)
    if args.trace is not None:
        trace_main_path(torch, lambda: interpolate(part, config=recommended,
                                                   device=dev),
                        args.trace, "periter_main_path_trace")

    # phases 7 and 8: the DCT and WAVELET folded solves on the same cube
    dct = dataclasses.replace(production, transform_kind="DCT")
    _, counts_dct, snr_dct, _, _ = main_path(
        torch, interpolate, cube, dct, dev, truth, s_in, "DCT main path",
        modules, {"pocs_solve[dct]": n_batches})
    if args.trace is not None:
        trace_main_path(torch, lambda: interpolate(cube, config=dct,
                                                   device=dev),
                        args.trace, "dct_main_path_trace")
    wavelet = dataclasses.replace(production, transform_kind="WAVELET",
                                  p_min=1e-5)
    _, counts_wv, snr_wv, _, _ = main_path(
        torch, interpolate, cube, wavelet, dev, truth, s_in,
        "WAVELET main path (db4, level 3)", modules,
        {"pocs_solve[wavelet]": n_batches})
    if args.trace is not None:
        trace_main_path(torch, lambda: interpolate(cube, config=wavelet,
                                                   device=dev),
                        args.trace, "wavelet_main_path_trace")

    # phase 9: the CURVELET main path, its production configuration
    curvelet = dataclasses.replace(production, transform_kind="CURVELET",
                                   p_min=1e-3)
    tr = _production_transform(curvelet, {})
    if (tr.precision, tr.box_precision) != ("high", "highest"):
        fail(f"the CURVELET production transform is {tr}")
    print(f"CURVELET production transform: {tr}", flush=True)
    cv_truth, cv_cube, cv_in = cut_to_fit(torch, interpolate, Cube, truth,
                                          mask, cube, s_in, curvelet, dev,
                                          "CURVELET")
    cv_batches = math.ceil(cv_truth.shape[0] / MAIN_BATCH)
    _, counts_cv, _, _, _ = main_path(
        torch, interpolate, cv_cube, curvelet, dev, cv_truth, cv_in,
        "CURVELET main path", modules,
        {"subband_update": cv_batches * NITER,
         "box_group_update": cv_batches * NITER})
    del cv_cube, cv_truth
    if args.trace is not None:
        trace_main_path(torch, lambda: interpolate(part, config=curvelet,
                                                   device=dev),
                        args.trace, "curvelet_main_path_trace")

    # phase 10: the SHEARLET main path through the spatial subband kernel,
    # on phase 5's cube
    with spatial_io():
        _, counts_sp, snr_sp, _, _ = main_path(
            torch, interpolate, sh_cube, shearlet, dev, sh_truth, sh_in,
            "SHEARLET main path, P3D_SPATIAL_IO=1", modules,
            {"subband_update[spatial]": sh_batches * NITER,
             "box_group_update": 2 * sh_batches * NITER})
        if args.trace is not None:
            trace_main_path(torch, lambda: interpolate(part, config=shearlet,
                                                       device=dev),
                            args.trace, "spatial_io_main_path_trace")
    print(f"SHEARLET SNR: spectral route (phase 5) {snr_sh:.3f} dB, spatial "
          f"route {snr_sp:.3f} dB", flush=True)
    if abs(snr_sp - snr_sh) > SNR_TOL_DB:
        fail(f"the spatial route's SNR {snr_sp:.3f} dB is not within "
             f"{SNR_TOL_DB} dB of the spectral route's {snr_sh:.3f} dB")
    del sh_truth
    torch.cuda.empty_cache()

    # phase 11: the stage-2 chain on the 512x512x1024 time cube
    t11 = time.perf_counter()
    stage2_chain(torch, dev, modules, args.trace)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s", flush=True)

    # phase 12: the plain scan route on phase 4's cube
    t12 = time.perf_counter()
    xla_scan_paths(torch, Cube, truth, mask, cube, s_in, production, dev,
                   modules, args.trace, part,
                   {"12a": snr_dct, "12b": snr_wv})
    print(f"phase 12: {time.perf_counter() - t12:.1f} s", flush=True)
    del part
    torch.cuda.empty_cache()

    # phase 13: SEG-Y profiles in, a SEG-Y cube out
    t13 = time.perf_counter()
    segy_in_segy_out(torch, dev, modules, args.trace)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)

    # phase 14: the cube drivers and the out-of-core passes
    t14 = time.perf_counter()
    drivers(torch, dev, modules, production, truth, mask, cube, wall_fft,
            sh_cube, args.trace)
    del truth, mask, sh_cube
    torch.cuda.empty_cache()
    streamed_passes(torch, dev, modules, args.trace)
    file_paths(torch, dev, production, cube)
    del cube
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)

    # phase 15: stage 1, SEG-Y profiles repaired on the card
    t15 = time.perf_counter()
    try:
        stage1_survey(torch, dev, modules, args.trace)
    except AssertionError as e:  # a repair or a card/host comparison missed
        import traceback

        traceback.print_exc()
        fail(f"phase 15: {e}")
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)
    print(f"all phases: {time.perf_counter() - t_start:.1f} s", flush=True)

    def entry(name, replaces, launches, err, ms, plain_ms, bnd,
              source="pocs_solve.cu"):
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": PALLAS + replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(smi)
    print(json.dumps({"kernels": [
        entry("pocs_solve[fft]", "pocs_iter.py:774",
              counts_fft["pocs_solve[fft]"], err_solve, solve_ms,
              solve_plain_ms, solve_bound),
        entry("pocs_solve[dct]", "pocs_iter.py:708",
              counts_dct["pocs_solve[dct]"], err_dct, dct_ms, dct_plain_ms,
              dct_bound),
        entry("pocs_solve[wavelet]", "pocs_iter.py:676",
              counts_wv["pocs_solve[wavelet]"], err_wv, wv_ms, wv_plain_ms,
              wv_bound),
        entry("pocs_iteration", "pocs_iter.py:242",
              counts_it["pocs_iteration"], err_iter, iter_ms, iter_plain_ms,
              iter_bound),
        entry("subband_update", "subband.py:392",
              counts_sh["subband_update"], err_a, sub_ms, sub_plain_ms,
              sub_bound, "subband.cu"),
        entry("subband_update[spatial]", "subband.py:110",
              counts_sp["subband_update[spatial]"], err_sp, sp_ms,
              sp_plain_ms, sp_bound, "subband.cu"),
        entry("box_group_update", "subband.py:316",
              counts_sh["box_group_update"], err_b, box_ms, box_plain_ms,
              box_bound, "subband.cu"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
