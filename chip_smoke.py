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
   asserts its route, no launch of any kernel, a finite
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
   (f) the same survey in IBM float (format 1) on every other live
   iline, 128 profiles (the sub-phase in about a minute): asserts
   ``backends.native_segy_enabled()`` (the native decoder, ``io/native``,
   built with g++) and that every full-file read is decoded by it; decodes
   every file natively and with numpy, bit for bit, and prints both
   walls and MB/s; then ``bin_cube`` on the card from the IBM files
   through the native decoder and through numpy: fold equal, the stack
   within 1e-5·max, no kernel launched, both walls printed.
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
   each step's Chrome trace). Asserts no launch of any kernel;
   the repairs against what the survey injected (delays exact, picks and
   the flattened seafloor within a sample, tide shifts exact, the mistie
   within a sample, every spike found and removed); and each device step
   (03, 05-08) on the card equal to ``device="cpu"`` on four profiles
   (07: a tie line and three lines it crosses, both runs on copies):
   headers and samples bit for bit, sidecars as numbers (misties.csv's
   correlations within 1e-6). Steps 01, 02 and 04 are host numpy and
   take no device.
16. the command line on the card (``pseudo_3d_interpolation_torch.cli``
   and ``pipeline.orchestrator``), with ``--device`` left to its
   default: (a) ``cli.main`` runs each stage-1 subcommand, 01-08, on the
   inputs phase 15's step got (passed as a datalist) with phase 15's
   options (``tests/torch_helpers.stage1_cli_steps``), each writing into
   a directory of its own; every output SEG-Y file must equal phase 15's
   output of the same step byte for byte, with no kernel launched; then
   ``run_pipeline`` runs the same eight steps from a dict config on
   phase 15's survey into a workdir, and the files of its last datalist
   must equal 16a's despike outputs byte for byte, with no kernel
   launched; (b) ``cli.main(["warmup", "--transform", FFT or SHEARLET,
   "--shape", "512", "512", "--slices", "513", "--batch", "32"])``, whose
   launches must be 14a's (one ``pocs_solve[fft]``; 50
   ``subband_update`` and 100 ``box_group_update``); (c) ``nav`` over the
   survey (GeoJSON, no pandas) and ``version``; prints
   ``backends.summary()`` and asserts platform 'cuda' with the kernels
   enabled, and that every 16a subcommand wrote its resolved-arguments
   sidecar, which names its command. The subcommands' own console output
   goes to a log file in the temporary directory; each one's wall and
   the phase's total are printed.
17. SHEARLET and CURVELET with a percentile threshold (the subband
   kernels split at the threshold around ``band_percentile``): (a) at
   the main path's shapes (batches 8 and 32 of 512², the 48 full-size
   SHEARLET bands and its 16- and 40-side box groups, the CURVELET
   plan's 41 bands and 72-side group; q from iteration 10 of phase 12d's
   decay of factors), pass 1's keys (``subband_keys``, ``box_keys``)
   within 1e-4·max of their plain versions and the first-digit
   histogram pass 1 counts equal to the plain version's,
   ``band_percentile`` bit-equal to its plain version on those keys and
   on edge cases (q 0 and 100, integer ranks, q outside [0, 100], a NaN
   key, runs of ties, first-digit bins past the candidate buffer), the
   split ``subband_update`` and ``box_group_update`` against their plain
   versions (soft within 1e-4·max, hard by iterate SNR), the box passes
   in the form each group's indices plan (``box_line_plan``: pruned on
   the 16-, 40- and 72-side groups, printed) and in the general form
   beside it; each pass timed at batch 32 (torch.profiler) with its
   rates, the box passes on the SHEARLET groups and on CURVELET's
   72-side group, the selection's
   kernels over a call's bands against their
   bound, and the selection's ms, GB/s and bound on one chunk's keys
   beside ``torch.kthvalue``'s on the same keys; (b) the
   512x512x513 cubes of phase 4 made anew through ``interpolate`` with
   ``device`` left to its default in phase 12d's configuration
   (production, ``hard-percentile``, ``decay_kind='factors'``, p_max
   99.9, p_min 60) on both bases, under phase 5's cut rule: route
   ``streamed-subband``, the launches of the split passes and the
   selection (per batch and iteration one of each pass per band chunk,
   one of each box pass per box group), no plain version called, a
   finite output (its SNR printed: this configuration does not beat the
   masked input on plane waves, in the JAX package either), and the
   first 4 slices within 0.1 dB of ``device="cpu"``.
18. the 1-D slice mesh on the one card: a world-size-1 NCCL group
   (``initialize_distributed`` on tcp://127.0.0.1 and a free port) and
   its mesh; ``pocs_interpolate_sharded`` on phase 4's first batch,
   ``interpolate(mesh=...)`` on phase 4's FFT cube and on the first 65
   slices as a SHEARLET cube, and ``interpolate_time_cube_sharded`` on
   phase 11's preprocessed time cube against ``apply_fft`` ->
   ``interpolate`` -> ``apply_ifft``: each bit-equal to the
   single-device call with the same launches. The mesh holds one
   device: the phase shows the sharded code path on the card, not
   collectives across cards. (e) the 65-slice SHEARLET cube on one card
   at batch 8 (a rank's batch on four cards) against batch 32 and 64
   (``mesh_check.py``'s single-card call takes ``interpolate``'s default
   64): the max-normalised gaps printed beside ``mesh_check.py``'s
   four-card 7.95e-3 and the SNRs, which must agree within 0.1 dB
   (ROADMAP queue 3 #8). (f) ``make_mesh_2d(1, 1)`` on the same group:
   the FFT cube's first 65 slices through ``interpolate(mesh=...)`` (one
   space rank: the 1-D slice path, bit-equal to the single-device call
   with the same launches), and through the space-sharded FFT solve (a
   distributed line FFT in PyTorch ops, no kernel launched) against the
   single-device folded solve within 1e-5·max, or by SNR within 0.1 dB
   (both end at the float32 floor).
19. the SHEARLET split plan (``shearlet_plan(512, 512,
   split_threshold=200)``: the finest scale re-grouped by each shear's
   exact support into box groups of 447x126, 126x447, 447x63 and
   63x447, non-contiguous index lists; the rest zero-padded into the
   full-size bands) on the box kernel, on phase 3b's plane waves with a
   seeded noise floor of rms 0.3 (energy in every band): (a) at batches
   8 and 32,
   ``subband_update`` and every box group against their plain versions
   (soft within 1e-4·max, hard by iterate SNR), the percentile route's
   ``box_keys`` within 1e-4·max, the selection bit-equal and the split
   updates likewise; (b) ``pocs_subband_apply`` at 32x512² on the split
   plan against the box plan: launches (one ``box_group_update`` per box
   group, no plain version called), ms a call, and the two results
   (soft within 1e-4·max, hard by iterate SNR); (c) each box group's
   kernel and plain time and bound at batch 32, both plans, and the
   percentile route's box passes on the split groups with the form each
   takes (general, but pruned on 447x63, whose columns are a wrapped
   range of 63); (d)
   ``shearlet_transform`` and ``inverse_shearlet_transform`` on the card
   against ``device="cpu"`` within 1e-5·max, and the pair's
   reconstruction.
20. the north-star runner (``examples/northstar_run_torch.py``, BASELINE
   config 5) on the card at full size: its synthetic 512x512x1024 cube
   with half the bins kept, built once, through the runner's ``run``
   (``interpolate_time_cube_sharded`` on a mesh of this one process:
   rfft, POCS on the 513 slices at batch 32, irfft, one upload and one
   download) with its defaults, 50 iterations, on SHEARLET (the
   production basis: 850 launches of ``subband_update`` and 1700 of
   ``box_group_update``, 17 batches × 50 iterations, two box groups a
   batch-iteration) and then the FFT basis (17 of ``pocs_solve[fft]``);
   asserts those launches and no other kernel, the output's shape and
   finiteness, and a reconstructed SNR above the sparse one (the
   runner's own SNR, on magnitudes for SHEARLET as the JAX runner takes
   it); prints the solver stage's wall, slice-iterations/s, the upload
   and download walls, the device peak and the SNRs.
Phases 4 to 10 and 12 print the wall time, slice-iterations/s and device
peak memory. Before each, and before phase 11's and 13c's chains, 13a's
binning, phase 15's steps and phase 20's runs, every kernel's
launch count is set to 0; after it, the counts of every kernel must
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
sheet's rates at 700 W; every count and the rule come from the port's
``utils/roofline.py``). Operations are counted as a fast transform does
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
beside it (3b, 3f). The percentile route's wrappers count their own
inputs and outputs: pass 1 (``subband_keys``, ``box_keys``) reads the
slices' spectra and the windows and writes the float32 keys (4 bytes per
slice, band and pixel), with one line FFT of each support row and of
every column (each field row for a box group: a full line FFT in the
general form, n/s′ s′-point FFTs and 6·n twiddle flops in the pruned
one); pass 2 (``subband_shrink``, ``box_shrink``) the subband kernel's
column and accumulating passes (a box group's row pass both ways in its
form and its summing column pass); the c_l pass 1 keeps for
pass 2 is the implementation's traffic, not the function's, and is not
counted; ``band_percentile`` reads
its keys once, and its ``library_ms`` is ``torch.kthvalue`` of one rank
of every segment of the same keys (the selection needs two ranks and the
interpolation, so that call does less).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
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


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def roofline():
    """The port's H100 roofline (``utils/roofline.py``): the fp32 peak,
    the memory rate, the bound rule and every kernel's operation and byte
    counts, from which each ``bound_ms`` here comes."""
    from pseudo_3d_interpolation_torch.utils import roofline as rl

    return rl


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms of a call and what sets it (``roofline.bound``)."""
    return roofline().bound(flops, nbytes)


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

    def __init__(self, torch, b, h, w, seed, dev, basis="SHEARLET",
                 split_threshold=None, noise=0.0):
        from pseudo_3d_interpolation_torch.models.transforms import (
            get_transform)
        from pseudo_3d_interpolation_torch.ops import shearlet as sh
        from pseudo_3d_interpolation_torch.ops.cplx import Cplx

        self.torch, self.h, self.w, self.b = torch, h, w, b
        self.truth, self.mask = plane_waves(torch, b, h, w, seed, dev)
        if noise:
            # a seeded complex noise floor of rms ``noise``: energy in
            # every band, where the plane waves' is all at low wavenumbers
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.truth += noise * torch.randn(self.truth.shape, device=dev,
                                              generator=gen,
                                              dtype=torch.complex64)
        self.obs = self.truth * self.mask
        z = Cplx(self.obs.real.contiguous(), self.obs.imag.contiguous())
        self.x = z
        tr = get_transform(basis, precision="high")
        p_min = "adaptive" if basis == "SHEARLET" else 1e-3
        tau = tr.decay_from_input(z, "exponential", NITER, 0.99, p_min,
                                  "values")[TAU_ITER]
        self.basis = basis
        # with ``split_threshold`` the SHEARLET split plan, its thresholds
        # in plan order (the decay's, permuted by the plan's ``perm``)
        plan = (tr._plan(h, w) if split_threshold is None else
                sh.shearlet_plan(h, w, split_threshold=split_threshold))
        self.perm = torch.from_numpy(plan.perm).to(dev)
        tau = tau[:, self.perm]
        self.full, full_idx, self.boxes = sh._plan_kernel_pack(plan, h, w)
        self.full_idx = full_idx
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
    if scale == 0.0:
        fail(f"{label} {op}: the plain version's output is all zero: the "
             "case checks nothing")
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
    bnd = bound(*roofline().box_work(case.b, lg, side, len(g.idx_w), N, N))
    box = f"{side}x{len(g.idx_w)}"
    print(f"box_group_update {case.b}x{box} ({lg} bands) of "
          f"{case.h}x{case.w}: kernel {four[0]:.3f} / {four[1]:.3f} ms, "
          f"plain (torch.matmul) {four[2]:.3f} / {four[3]:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    # the passes: (1) the box columns into field columns, (2) every field
    # row both ways, (3) the field columns back to the box, band-summed
    b, nh, nw = case.b, case.h, case.w
    print_passes(f"box_group_update {b}x{box}", kernel_passes(
        torch, lambda: ksb.box_group_update(*bargs, "high", index=index),
        BOX_PASSES), roofline().box_pass_work(b, lg, side, len(g.idx_w), nh,
                                              nw))
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


# profiles taken of one run before a missing pass fails (the card's
# machine has handed back two empty traces of three in a row)
PROFILE_ATTEMPTS = 5


def profiled_events(torch, run, reps: int, want=(), launches=None) -> list:
    """The device events of ``reps`` calls of ``run`` under torch.profiler,
    after one untimed call, in the order they started. The profiler now
    and then hands back a trace without the device's kernels, or with the
    kernels of only some calls, so the profile is taken again, up to
    PROFILE_ATTEMPTS times, while no event names a kernel of ``want``, or
    while the trace holds another count than ``reps`` times ``launches``
    of a pass (``launches``: a pass and its launches a call, or a dict of
    such); each such attempt is printed with what its trace held. The
    caller fails on a pass still missing; an incomplete count still fails
    here."""
    from torch.profiler import ProfilerActivity, profile

    counts = (dict([launches]) if isinstance(launches, tuple)
              else dict(launches or {}))
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
        short = [(name, sum(name in e["name"] for e in events), reps * n)
                 for name, n in counts.items()]
        short = [c for c in short if c[1] != c[2]]
        if not missing and not short:
            break
        seen = sorted({e["name"][:40] for e in events})[:4]
        print(f"profile attempt {attempt} of {PROFILE_ATTEMPTS}: the trace "
              f"({len(events)} device events, e.g. {seen}) holds "
              + (f"no {', '.join(missing)}" if missing else
                 f"{short[0][1]} {short[0][0]} launches, not {reps} calls' "
                 f"{short[0][2]}"), flush=True)
    if short:
        fail(f"no profile of {PROFILE_ATTEMPTS} held the {reps} calls' "
             f"{short[0][2]} {short[0][0]} launches (last {short[0][1]})")
    return sorted(events, key=lambda e: e["ts"])


def only_passes(events: list, names) -> list:
    """``events``, failing on any whose name contains none of ``names``."""
    for e in events:
        if not any(n in e["name"] for n in names):
            fail(f"{e['name'][:80]} ran in a profile of {names}")
    return events


def kernel_passes(torch, run, names, reps: int = 3,
                  exclusive: bool = False, want=None, launches=None) -> dict:
    """ms per call of each pass (device kernel, by a name in ``names``
    that its trace name contains, the longest such name) of ``reps``
    calls of ``run`` under torch.profiler, after one untimed call, taken
    again while a pass of ``want`` (all of ``names`` by default) is
    missing or, with ``launches`` (a pass and its launches a call, or a
    dict of such), while the trace holds another count of a pass than the
    ``reps`` calls launched; with ``exclusive`` fails when anything else
    ran on the device."""
    times = dict.fromkeys(names, 0.0)
    events = profiled_events(torch, run, reps,
                             names if want is None else want, launches)
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
    """(bytes, flops) of each pass of one subband call on a SubbandCase
    (``roofline.subband_pass_work`` on its windows' support rows, bands
    and band chunks)."""
    return roofline().subband_pass_work(*case_support(case), spatial)


def case_support(case) -> tuple:
    """(batch, h, w, support rows, bands, band chunks) of a
    SubbandCase."""
    offsets = case.support.offsets
    return (case.b, case.h, case.w, int(offsets[-1]), len(offsets) - 1,
            len(case.chunks) - 1)


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
    rl = roofline()
    b, h, w, nbands = case.b, case.h, case.w, case.psi.shape[0]
    flops, nbytes = rl.subband_work(*case_support(case), spatial)
    bnd = bound(flops, nbytes)
    dense = bound(rl.subband_dense_flops(b, h, w, nbands, spatial), nbytes)
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
           "box_group_update", "subband_keys", "subband_shrink", "box_keys",
           "box_shrink", "band_percentile")
# the wrappers of the subband module counted under their own names
SUBBAND_WRAPPERS = ("subband_update", "box_group_update", "subband_keys",
                    "subband_shrink", "box_keys", "box_shrink")


def launch_counts(ks, ksb, kp) -> dict:
    """Every kernel's launch count, by the names of the ``kernels`` line."""
    by_basis = ks.pocs_solve.launches_by_basis
    counts = {"pocs_solve[fft]": by_basis["fft"],
              "pocs_solve[dct]": by_basis["dct"],
              "pocs_solve[wavelet]": by_basis["wavelet"],
              "pocs_iteration": ks.pocs_iteration.launches,
              "subband_update[spatial]": ksb.subband_update_spatial.launches,
              "band_percentile": kp.band_percentile.launches}
    counts.update({name: getattr(ksb, name).launches
                   for name in SUBBAND_WRAPPERS})
    return {name: counts[name] for name in KERNELS}


def reset_counts(ks, ksb, kp):
    ks.reset_launches()
    for name in SUBBAND_WRAPPERS + ("subband_update_spatial",):
        getattr(ksb, name).launches = 0
    kp.band_percentile.launches = 0


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
              modules, expected, default_device=False, beat_masked=True):
    """Run ``interpolate`` once with every kernel count set to 0 just
    before; check that the counts just after are ``expected`` (zero for
    every other kernel), the output and, with ``beat_masked``, that the
    SNR beats the masked input's; print the wall time, the rate, the mean
    effective iterations and the device peak. ``config`` is a
    ``POCSConfig`` or a YAML-style dict; ``default_device`` leaves
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
    if beat_masked and not s_out > s_in:
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


def write_survey(torch, dev, directory: pathlib.Path, ilines, seed=0,
                 fmt=5):
    """One SEG-Y profile (format ``fmt``, coordinates in cm with
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
        write_segy(str(path), host, fmt=fmt, dt_us=SURVEY_DT_US, headers={
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


# phase 13f: the survey in IBM float through the native decoder
IBM_PROFILES = 128  # every other live iline: the sub-phase in about 60 s


def segy_ibm_survey(torch, dev, modules):
    """Phase 13f: phase 13's survey written in IBM float (format 1, as
    TOPAS and SBP surveys arrive) on every other live iline
    (IBM_PROFILES profiles of 2048 x 896). Asserts that the native decoder
    (``io/native``, built here with g++) is enabled and that every
    full-file read is decoded by it (its ``decode_traces`` returns 0);
    decodes every file both ways, native
    (``SegyFile.trace_data()``) and numpy (``_decode_samples``), bit for
    bit, and prints both walls and MB/s of decoded samples; then
    ``bin_cube`` on the card from the format-1 files, once through the
    native decoder and once with it off (numpy), fold equal and the stack
    within BIN_TOL of max (``index_add_`` adds in the order its atomics
    land), with no kernel launched."""
    from pseudo_3d_interpolation_torch import backends
    from pseudo_3d_interpolation_torch.io import native
    from pseudo_3d_interpolation_torch.io.segy import (TRACE_HEADER_SIZE,
                                                        SegyFile,
                                                        _decode_samples)
    from pseudo_3d_interpolation_torch.pipeline.binning import (
        BinningGeometry, bin_cube)

    if not backends.native_segy_enabled():
        fail("13f: the native SEG-Y decoder is not enabled on the card's "
             f"machine: {backends.native_segy_error()}")
    ilines = np.flatnonzero(chain_fold(N, N)[:, 0])[::2][:IBM_PROFILES]
    n_traces = len(ilines) * SURVEY_TRACES
    mb = n_traces * SURVEY_NS * 4 / 1e6
    with tempfile.TemporaryDirectory(prefix="p3d_ibm_") as tmp:
        survey = pathlib.Path(tmp) / "survey"
        survey.mkdir()
        t0 = time.perf_counter()
        files, t_write = write_survey(torch, dev, survey, ilines, fmt=1)
        print(f"13f IBM-float survey: {len(ilines)} profiles x "
              f"{SURVEY_TRACES} x {SURVEY_NS} (format 1, {mb:.0f} MB of "
              f"samples); write_segy {t_write:.2f} s, made and written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        real_lib = native.lib
        used = [0]

        class CountingLib:
            """The loaded library, counting the full-file decodes that
            succeed (a nonzero return falls back to numpy in silence)."""

            def __init__(self, cdll):
                self._cdll = cdll

            def decode_traces(self, *args):
                rc = self._cdll.decode_traces(*args)
                used[0] += rc == 0
                return rc

            def __getattr__(self, name):
                return getattr(self._cdll, name)

        def counting_lib():
            cdll = real_lib()
            return None if cdll is None else CountingLib(cdll)
        t_native = t_numpy = 0.0
        native.lib = counting_lib
        try:
            for path in files:
                with SegyFile(path) as f:
                    if f.format != 1:
                        fail(f"13f: {path} is format {f.format}")
                    t1 = time.perf_counter()
                    a = f.trace_data()
                    t2 = time.perf_counter()
                    b = _decode_samples(np.asarray(
                        f._traces_u8[:, TRACE_HEADER_SIZE:]), 1)
                    t3 = time.perf_counter()
                t_native += t2 - t1
                t_numpy += t3 - t2
                if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
                    fail(f"13f: the native decode of {path} differs from "
                         "numpy's")
        finally:
            native.lib = real_lib
        if used[0] != len(files):
            fail(f"13f: {used[0]} of {len(files)} full-file reads were "
                 "decoded natively")
        print(f"13f decode of {len(files)} IBM files, bit-equal: native "
              f"({'OpenMP' if native.openmp() else 'one thread: the '
                 'compiler has no OpenMP runtime'}) "
              f"{t_native:.3f} s ({mb / t_native:.0f} MB/s), numpy "
              f"{t_numpy:.3f} s ({mb / t_numpy:.0f} MB/s), "
              f"{t_numpy / t_native:.2f}x", flush=True)

        geom = BinningGeometry(spacing=BIN_SPACING, extent=BIN_EXTENT,
                               stacking_method="average")
        reset_counts(*modules)
        binned, wall, peak = timed(torch, dev,
                                   lambda: bin_cube(str(survey), geom))
        native.lib = lambda: None  # the numpy decode
        try:
            plain, wall_np, _ = timed(torch, dev,
                                      lambda: bin_cube(str(survey), geom))
        finally:
            native.lib = real_lib
        counts = launch_counts(*modules)
        if any(counts.values()):
            fail(f"13f bin_cube launched kernels: {counts}")
        if not np.array_equal(binned["fold"], plain["fold"]):
            fail("13f: the fold from the native decode differs from numpy's")
        err = float(np.abs(binned["amp"] - plain["amp"]).max()
                    / np.abs(plain["amp"]).max())
        print(f"13f bin_cube on the card from the IBM files: native decode "
              f"{wall:.3f} s ({n_traces / wall:.0f} traces/s, device peak "
              f"{peak:.3f} GB), numpy decode {wall_np:.3f} s; fold equal, "
              f"stack max|d| {err:.2e} of max", flush=True)
        if err > BIN_TOL:
            fail(f"13f: the cube from the native decode is {err:.2e} of max "
                 "from numpy's")


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


def stage1_survey(torch, dev, modules, trace_dir, tmp):
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
    subset): headers and samples bit for bit, sidecars as numbers. Works
    in the directory ``tmp``; returns the survey's files, its truth, and
    each step's inputs and outputs, for phase 16."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "tests"))
    from torch_helpers import (check_stage1_truth, same_csv, same_outputs,
                               stage1_steps, write_stage1_survey)

    from pseudo_3d_interpolation_torch.pipeline import stage1 as st

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
    # step 01's input was the directory, which now holds every output too
    step_inputs = [files] + [inputs[f"{k + 1:02d} {name}"]
                             for k, (name, _, _) in enumerate(steps)][1:]
    return {"files": files, "truth": truth, "inputs": step_inputs,
            "outs": [outs[f"{k + 1:02d} {name}"]
                     for k, (name, _, _) in enumerate(steps)]}


# phase 16: the command line on the card
@contextlib.contextmanager
def quiet(path: pathlib.Path):
    """The block's standard output appended to ``path``."""
    with open(path, "a") as fh, contextlib.redirect_stdout(fh):
        yield


def command_line(torch, dev, modules, stage1, tmp):
    """Phase 16: stage 1 through ``cli.main`` and ``run_pipeline`` against
    phase 15's outputs (16a), ``p3d-torch warmup``'s launches (16b),
    ``nav``, ``version``, ``backends.summary()`` and the sidecars (16c).
    ``stage1`` is what :func:`stage1_survey` returned; ``tmp`` its
    directory."""
    import io

    from torch_helpers import (cli_step_outputs, run_stage1_cli, same_bytes,
                               stage1_cli_steps, stage1_pipeline_steps)

    from pseudo_3d_interpolation_torch import __version__, backends, cli
    from pseudo_3d_interpolation_torch.pipeline.orchestrator import \
        run_pipeline

    tide = stage1["truth"]["tide"]
    inputs, outs = stage1["inputs"], stage1["outs"]
    log = tmp / "phase16.log"
    t16 = time.perf_counter()
    # 16a: each subcommand on the inputs phase 15's step got
    (tmp / "cli").mkdir()
    walls = {}
    reset_counts(*modules)
    with quiet(log):
        dirs = run_stage1_cli(cli.main, inputs, tmp / "cli", tide,
                              walls=walls)
    expect_counts(modules, "16a cli", {})
    for k, (cmd, _) in enumerate(stage1_cli_steps(tide)):
        got = cli_step_outputs(outs[k], inputs[k], dirs[k])
        try:
            same_bytes(got, outs[k])
        except AssertionError as e:
            fail(f"16a {cmd}: the command line's output differs from phase "
                 f"15's: {e}")
        print(f"16a p3d-torch {cmd}: {walls[cmd]:.3f} s wall, {len(got)} "
              f"files equal to phase 15's byte for byte", flush=True)
    print(f"16a stage 1 through cli.main: {sum(walls.values()):.2f} s wall, "
          f"no kernel launched", flush=True)
    despiked = cli_step_outputs(outs[-1], inputs[-1], dirs[-1])
    # ... and from one config, on the survey's original files
    survey_list = tmp / "survey.txt"
    survey_list.write_text("".join(p + "\n" for p in stage1["files"]))
    reset_counts(*modules)
    t0 = time.perf_counter()
    with quiet(log):
        final = run_pipeline({"input": str(survey_list),
                              "workdir": str(tmp / "run"),
                              "steps": stage1_pipeline_steps(tide)})
    wall = time.perf_counter() - t0
    expect_counts(modules, "16a run_pipeline", {})
    ran = open(final).read().split()
    try:
        same_bytes(ran, despiked)
    except AssertionError as e:
        fail(f"16a run_pipeline: its outputs differ from the command "
             f"line's: {e}")
    print(f"16a run_pipeline, steps 01-08 from one config: {wall:.2f} s "
          f"wall, {len(ran)} files of {os.path.basename(final)} equal to "
          f"16a's despike outputs byte for byte, no kernel launched",
          flush=True)

    # 16b: p3d-torch warmup, the launches of 14a
    for transform, want in (("FFT", {"pocs_solve[fft]": 1}),
                            ("SHEARLET", {"subband_update": NITER,
                                          "box_group_update": 2 * NITER})):
        reset_counts(*modules)
        t0 = time.perf_counter()
        with quiet(log):
            rc = cli.main(["warmup", "--transform", transform, "--shape",
                           str(N), str(N), "--slices", str(SLICES),
                           "--batch", str(MAIN_BATCH)])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"16b warmup {transform}: exit code {rc}")
        path = expect_counts(modules, f"16b warmup {transform}", want)
        print(f"16b p3d-torch warmup --transform {transform} --shape {N} {N} "
              f"--slices {SLICES} --batch {MAIN_BATCH}: {wall:.3f} s wall, "
              f"launches {path}", flush=True)

    # 16c: nav, version, the capability flags and the sidecars
    geojson = tmp / "nav.geojson"
    t0 = time.perf_counter()
    with quiet(log):
        rc = cli.main(["nav", str(survey_list), str(geojson)])
    wall = time.perf_counter() - t0
    features = json.loads(geojson.read_text())["features"]
    n_traces = sum(f["properties"]["n_traces"] for f in features)
    want = sum(int(v["valid"].sum())
               for v in stage1["truth"]["lines"].values())
    if rc != 0 or n_traces != want:
        fail(f"16c nav: exit code {rc}, {n_traces} traces != {want}")
    print(f"16c p3d-torch nav: {wall:.3f} s wall, {len(features)} lines, "
          f"{n_traces} traces (no pandas)", flush=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["version"])
    if rc != 0 or out.getvalue().strip() != __version__:
        fail(f"16c version: exit code {rc}, printed {out.getvalue()!r}")
    summary = backends.summary()
    print(f"16c p3d-torch version: {__version__}; backends.summary(): "
          f"{summary}", flush=True)
    if summary["platform"] != "cuda" or not summary["kernels"]:
        fail("16c: backends.summary() should report platform 'cuda' with "
             "the kernels enabled")
    for (cmd, _), d in zip(stage1_cli_steps(tide), dirs):
        found = glob.glob(os.path.join(d, f"*_p3d_{cmd}_argparse_"
                                          "parameter.yml"))
        if len(found) != 1 or f'command: "{cmd}"' not in open(found[0]).read():
            fail(f"16c: {cmd} left no sidecar naming it in {d}: {found}")
    print("16c every 16a subcommand wrote its resolved-arguments sidecar",
          flush=True)
    print(f"phase 16 subcommands' console output: "
          f"{len(log.read_text().splitlines())} lines (not shown)",
          flush=True)
    return time.perf_counter() - t16


# phase 17: SHEARLET and CURVELET with percentile thresholds
PCT_META = {"thresh_op": "hard-percentile", "decay_kind": "factors",
            "p_max": 99.9, "p_min": 60.0}  # phase 12d's configuration
PCT_CHECK = 4  # 17b: first slices held against device="cpu"
# the selection's kernels (band_percentile.cu): the plan from the first
# digit's histogram, the gather of the rank's bin, the finishing digits
SELECT_PASSES = ("select_plan_kernel", "select_gather_kernel",
                 "select_finish_kernel")
# the split route: pass 1 writes the keys and keeps c_l, pass 2 reads it
KEY_PASSES = (("rows_inverse_kernel", "cols_keys_kernel")
              + SELECT_PASSES + ("cols_kept_kernel", "rows_forward_acc_kernel"))
# the plain versions the percentile route has on the host; none may run on
# the card's main path
PLAIN_NAMES = ("subband_keys_plain", "subband_shrink_plain",
               "subband_update_plain", "box_keys_plain",
               "box_group_update_plain")


def percentiles(torch, case):
    """(q of the full-size bands (B, Lf), [q of each box group (B, lg)]) of
    a SubbandCase: iteration TAU_ITER of the decay of phase 12d's
    configuration (factors from p_max 99.9 down to p_min 60)."""
    from pseudo_3d_interpolation_torch.models.transforms import get_transform

    tr = get_transform(case.basis, precision="high")
    q = tr.decay_from_input(case.x, "exponential", NITER, PCT_META["p_max"],
                            PCT_META["p_min"], "factors")[TAU_ITER]
    q = q[:, case.perm]  # in the case's plan order
    idx = torch.from_numpy(case.full_idx).to(case.dev)
    return (q[:, idx].contiguous(),
            [q[:, l0:l0 + lg].contiguous() for l0, lg, _ in case.boxes])


def bits_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def selection_against_plain(torch, kp, keys, q, label, hist=None):
    """Fail unless band_percentile is bit-equal to its plain version on
    ``keys`` (S, C, H, W) at ``q`` (S, C); ``hist``: the keys' first-digit
    histogram as pass 1 counted it, else the plain version's."""
    if hist is None:
        hist = kp.key_histogram_plain(keys)
    got = kp.band_percentile(keys, q, hist)
    want = kp.band_percentile_plain(keys, q)
    torch.cuda.synchronize()
    if not bits_equal(torch, got, want):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        fail(f"band_percentile {label}: {bad} of {got.numel()} thresholds "
             "differ from the plain version's bits")
    return got


def histogram_against_plain(torch, kp, hist, keys, label):
    """Fail unless pass 1's first-digit histogram equals the plain
    version's of the keys it wrote."""
    torch.cuda.synchronize()
    want = kp.key_histogram_plain(keys)
    if not torch.equal(hist, want):
        bad = int((hist != want).any(dim=-1).sum())
        fail(f"{label}: pass 1's histogram differs from the plain version's "
             f"in {bad} of {want.shape[0] * want.shape[1]} segments")


def bin_sizes(torch, kp, hist, q, label):
    """Print how many keys the first-digit bin of rank lo holds in each
    segment (what the selection gathers as candidates), and the share of
    segments past the candidate buffer."""
    n_cols = hist.shape[-1]
    counts = hist.reshape(-1, n_cols)[:, :kp.KEY_BINS].long()
    n = int(counts[0].sum())
    top = float(np.float32(n) - np.float32(1))
    lo = torch.floor(q.reshape(-1) / torch.full_like(q.reshape(-1), 100.0)
                     * top).clamp(0, n - 1).long()
    digit = torch.searchsorted(torch.cumsum(counts, 1), lo[:, None],
                               right=True)
    held = counts.gather(1, digit)[:, 0].double() / n
    cap = kp.candidate_capacity(n)
    print(f"{label}: rank lo's first-digit bin holds {float(held.mean()):.3f} "
          f"of a segment's keys on average, {float(held.max()):.3f} at most; "
          f"{float((held * n > cap).double().mean()):.3f} of the segments "
          f"past the candidate buffer", flush=True)


def selection_cases(torch, kp, keys, q):
    """The selection on the edge cases of its plain version, each bit-equal:
    q at 0, 100, ranks that land on an integer, a segment holding a NaN,
    keys with long runs of ties, q above 100 and below 0; and bins past
    the candidate buffer (all-equal keys, keys inside one quarter of an
    exponent), which the finishing block takes over the keys."""
    k = keys[:2, :4].clone()
    s, c = k.shape[:2]
    n = k.shape[-2] * k.shape[-1]
    top = float(np.float32(n) - np.float32(1))
    on_rank = torch.tensor([100.0 * r / top for r in (0, 1, n // 3, n - 2)],
                           dtype=torch.float32, device=k.device)
    cases = {"q 0": torch.zeros(s, c), "q 100": torch.full((s, c), 100.0),
             "integer ranks": on_rank.expand(s, c),
             "q outside [0, 100]": torch.tensor([-5.0, 150.0]).repeat(
                 s * c // 2).reshape(s, c)}
    for label, qq in cases.items():
        selection_against_plain(torch, kp, k, qq.to(k.device).contiguous(),
                                label)
    nan = k.clone()
    nan[0, 1, 3, 5] = float("nan")
    t = selection_against_plain(torch, kp, nan, q[:2, :4].contiguous(),
                                "a NaN key")
    if not bool(torch.isnan(t[0, 1])) or bool(torch.isnan(t[0, 0])):
        fail("band_percentile: a NaN key does not give NaN in its segment "
             "alone")
    ties = torch.round(k * 4.0) / 4.0
    selection_against_plain(torch, kp, ties.contiguous(),
                            q[:2, :4].contiguous(), "ties")
    over = k.clone()
    over[0] = 0.37  # all equal
    over[1] = 1.0 + 0.25 * torch.rand(over[1].shape, device=k.device,
                                      generator=torch.Generator(
                                          device=k.device).manual_seed(17))
    hist = kp.key_histogram_plain(over)
    first = hist[..., :kp.KEY_BINS].max(dim=-1).values
    if int(first.min()) <= kp.candidate_capacity(n):
        fail("band_percentile: the over-capacity case fits the candidates")
    selection_against_plain(torch, kp, over, q[:2, :4].contiguous(),
                            "bins past the candidate buffer", hist)
    print(f"band_percentile: bit-equal to its plain version on q 0 and 100, "
          f"integer ranks, q outside [0, 100], a NaN key, runs of ties and "
          f"8 segments whose bin holds {int(first.min())}-{int(first.max())} "
          f"keys, past the candidate buffer's {kp.candidate_capacity(n)}",
          flush=True)


def box_forms(ksb, index) -> list:
    """(label, index) of each form of the percentile route's box row pass
    on a group: the form its indices plan (``index.line``, box_line_plan),
    and the general form beside it where that is the pruned one."""
    if index.line is None:
        return [("general form", index)]
    o, line = index.line
    return [(f"pruned form (o={o}, s'={line})", index),
            ("general form", ksb.BoxIndex(index[0], index[1], None))]


def percentile_kernels(torch, ksb, kp, dev) -> dict:
    """Phase 17a: the percentile route's kernels at the main path's shapes
    (batches 8 and 32 of 512², the 48 full-size SHEARLET bands, its 16-
    and 40-side box groups, the CURVELET plan's 41 bands and 72-side
    group), q from phase 12d's configuration. The selection bit-equal to
    its plain version on the keys of pass 1 and on edge cases; the split
    subband_update and box_group_update against their plain versions
    (soft within SOFT_TOL, hard by iterate SNR within SNR_TOL_DB), the box
    passes in both forms (box_forms); the passes timed at batch 32, the
    box passes on every group. Returns the numbers of the kernels line
    (the box wrappers' over the SHEARLET groups, as PERF.md's row 4b)."""
    out = {}
    err_keys = err_box_keys = err_a = err_b = 0.0
    for name, b in (("SHEARLET", 8), ("CURVELET", 8),
                    ("SHEARLET", MAIN_BATCH), ("CURVELET", MAIN_BATCH)):
        case = SubbandCase(torch, b, N, N, 1700 + b, dev, name)
        q_full, q_boxes = percentiles(torch, case)
        # pass 1 of the first chunk and the selection on its keys
        l0, l1 = (int(v) for v in case.chunks[:2])
        work = ksb.percentile_work(case.spec, case.support)
        keys, hist = ksb.subband_keys(case.spec, case.psi, case.support, l0,
                                      l1, work)
        histogram_against_plain(torch, kp, hist, keys,
                                f"subband_keys {name} {b}x{N}x{N}")
        plain = ksb.subband_keys_plain(case.spec, case.psi[l0:l1])
        e = float(torch.max(torch.abs(keys - plain)) / torch.max(plain))
        err_keys = max(err_keys, e)
        if e > SOFT_TOL:
            fail(f"subband_keys {name} {b}x{N}x{N}: max|d| {e:.2e} of max")
        del plain
        for k, (_, lg, g) in enumerate(case.boxes):
            _, args, index = case.box_args(k, "hard")
            box = f"{name} {b}x{len(g.idx_h)}x{len(g.idx_w)}"
            plain = ksb.box_keys_plain(args[0], args[1], args[3], N, N)
            for form, idx in box_forms(ksb, index):
                work_b = torch.empty(
                    ksb.box_work_floats(b, lg, len(g.idx_w), N), device=dev)
                got, hist_b = ksb.box_keys(args[0], args[1], args[3], N, N,
                                           index=idx, work=work_b)
                histogram_against_plain(torch, kp, hist_b, got,
                                        f"box_keys {box}, {form}")
                e = float(torch.max(torch.abs(got - plain))
                          / torch.max(plain))
                err_box_keys = max(err_box_keys, e)
                print(f"box_keys {box} ({lg} bands), {form}: max|d| "
                      f"{e:.2e} of max", flush=True)
                if e > SOFT_TOL:
                    fail(f"box_keys {box}, {form}: max|d| {e:.2e} of max")
                selection_against_plain(torch, kp, got, q_boxes[k],
                                        f"{box} box group, {form}", hist_b)
                if b == MAIN_BATCH and idx is index:
                    bin_sizes(torch, kp, hist_b, q_boxes[k],
                              f"{name} {b}x{lg} box group")
                del got, work_b
            del plain
        q = q_full[:, l0:l1].contiguous()
        selection_against_plain(torch, kp, keys, q,
                                f"{name} {b}x{l1 - l0} bands of {N}x{N}",
                                hist)
        if b == 8 and name == "SHEARLET":
            selection_cases(torch, kp, keys.contiguous(), q)
        if b == MAIN_BATCH and name == "SHEARLET":
            bin_sizes(torch, kp, hist, q, f"{name} {b}x{l1 - l0} bands")
            out["select"] = time_selection(torch, kp, keys, q, hist)
        del keys, work, hist
        for op in ("soft", "hard"):
            ea, eb = percentile_against_plain(torch, ksb, case, op, q_full,
                                              q_boxes)
            err_a, err_b = max(err_a, ea), max(err_b, eb)
        if b == MAIN_BATCH and name == "SHEARLET":
            out.update(percentile_passes(torch, ksb, kp, case, q_full,
                                         q_boxes))
        elif b == MAIN_BATCH:  # CURVELET's 72-side group, printed
            box_percentile_passes(torch, ksb, kp, case, q_boxes)
        del case
        torch.cuda.empty_cache()
    out.update(err_keys=err_keys, err_box_keys=err_box_keys, err_a=err_a,
               err_b=err_b)
    return out


def percentile_against_plain(torch, ksb, case, op, q_full, q_boxes):
    """The split subband_update and box_group_update of one SubbandCase
    against their plain versions; returns their max|d|."""
    c = case
    cplx = torch.complex
    want_a = ksb.subband_update_percentile_plain(c.spec, c.psi, q_full, op)
    got_a = ksb.subband_update_percentile(c.spec, c.psi, q_full,
                                          f"{op}-percentile", "high",
                                          support=c.support)
    box_plain, box_got = [], []
    for k in range(len(c.boxes)):
        sel, args, index = c.box_args(k, op)
        args = args[:2] + (q_boxes[k],) + args[3:]
        m = ksb.box_group_update_percentile_plain(*args)
        box_plain.append((sel, cplx(m.re, m.im)))
        for form, idx in box_forms(ksb, index):
            m = ksb.box_group_update_percentile(*args, "high", index=idx)
            box_got.append((k, form, cplx(m.re, m.im)))
    want_a, got_a = cplx(want_a.re, want_a.im), cplx(got_a.re, got_a.im)
    label = (f"subband_update[percentile] {c.basis} {c.b}x{c.h}x{c.w} "
             f"({c.psi.shape[0]} bands, {len(c.chunks) - 1} chunks)")
    err_a = compare(torch, label, op, got_a, want_a,
                    c.iterate_snr(got_a, box_plain),
                    c.iterate_snr(want_a, box_plain))
    err_b = 0.0
    for k, form, got_b in box_got:
        sel, want_b = box_plain[k]
        with_k = [(s, got_b if j == k else m)
                  for j, (s, m) in enumerate(box_plain)]
        label = (f"box_group_update[percentile] {c.basis} {c.b}x"
                 f"{len(sel[1])}x{sel[2].shape[1]} of {c.h}x{c.w}, {form}")
        err_b = max(err_b, compare(torch, label, op, got_b, want_b,
                                   c.iterate_snr(want_a, with_k),
                                   c.iterate_snr(want_a, box_plain)))
    return err_a, err_b


def time_selection(torch, kp, keys, q, hist) -> dict:
    """The selection on the keys of one chunk at the main path's batch
    (pass 1's histogram): kernel and plain (a sort), torch.kthvalue's one
    rank of each segment as the library call, the GB/s of one read of the
    keys and the bound."""
    s, c, h, w = keys.shape
    n = h * w
    flat = keys.transpose(-1, -2).reshape(s * c, n)
    top = float(np.float32(n) - np.float32(1))
    k = int(math.floor(float(q[0, 0]) / 100.0 * top)) + 1
    t_k, t_p, four = time_pair(torch,
                               lambda: kp.band_percentile(keys, q, hist),
                               lambda: kp.band_percentile_plain(keys, q), 5)
    torch.kthvalue(flat, k, dim=-1)
    lib_ms = time_ms(torch, lambda: torch.kthvalue(flat, k, dim=-1), 5)
    nbytes = roofline().select_work(s * c, n)[1]
    bnd = bound(0.0, nbytes)
    print(f"band_percentile {s}x{c} segments of {n} keys: kernel "
          f"{four[0]:.3f} / {four[1]:.3f} ms ({nbytes / t_k / 1e9:.3f} TB/s "
          f"of one read), plain (torch.sort) {four[2]:.3f} / {four[3]:.3f} "
          f"ms, torch.kthvalue (one rank) {lib_ms:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return {"ms": t_k, "plain_ms": t_p, "library_ms": lib_ms, "bound": bnd,
            "segments": s * c, "n": n}


def select_work(rl, kp, segments, n) -> dict:
    """(bytes, flops) of the selection's kernels as print_passes takes
    them: the plan reads the histograms, the gather the keys once, the
    finish the candidates (not counted: they depend on the data)."""
    return {"select_plan_kernel": (4 * segments * (kp.HIST_COLS + 1), 0.0),
            "select_gather_kernel": (rl.select_work(segments, n)[1], 0.0),
            "select_finish_kernel": (0, 0.0)}


def percentile_passes(torch, ksb, kp, case, q_full, q_boxes) -> dict:
    """Time the split route's wrappers on a SubbandCase at the main path's
    batch: each pass on the card (torch.profiler), each plain version
    (CUDA events), and each wrapper's bound: its inputs read and outputs
    written once, its line FFTs as pass_work counts them. Returns
    {wrapper: (ms, plain ms, bound)} over every chunk of the full-size
    bands and, for the box wrappers, the mean over the box groups;
    "select_call": the selection's kernels over a call's bands."""
    c = case
    b, h, w = c.b, c.h, c.w
    rl = roofline()
    work = pass_work(c, False)
    nbands = c.psi.shape[0]
    lh = rl.line_flops(h)
    key_bytes = b * nbands * h * w * 4
    rows_bytes = b * int(c.support.offsets[-1]) * w * 8
    cl_bytes = 8 * b * nbands * h * w

    def run():
        ksb.subband_update_percentile(c.spec, c.psi, q_full,
                                      "hard-percentile", "high",
                                      support=c.support)
    times = kernel_passes(torch, run, KEY_PASSES,
                          launches=("select_plan_kernel", len(c.chunks) - 1))
    print_passes(
        f"subband_update[percentile] {b}x{h}x{w} ({nbands} bands, "
        f"{len(c.chunks) - 1} chunks)", times, {
            "rows_inverse_kernel": work["rows_inverse_kernel"],
            "cols_keys_kernel": (rows_bytes + key_bytes + cl_bytes,
                                 b * nbands * w * lh),
            **select_work(rl, kp, b * nbands, h * w),
            "cols_kept_kernel": (cl_bytes + rows_bytes, b * nbands * w * lh),
            "rows_forward_acc_kernel": work["rows_forward_acc_kernel"]})
    p1 = times["rows_inverse_kernel"] + times["cols_keys_kernel"]
    p2 = times["cols_kept_kernel"] + times["rows_forward_acc_kernel"]
    selt = sum(times[n] for n in SELECT_PASSES)
    print(f"subband_update[percentile] {b}x{h}x{w}: pass 1 {p1:.3f} ms, "
          f"pass 2 {p2:.3f} ms, passes 1 + 2 {p1 + p2:.3f} ms, the "
          f"selection {selt:.3f} ms, the update {p1 + p2 + selt:.3f} ms",
          flush=True)
    tau = kp.band_percentile_plain(ksb.subband_keys_plain(c.spec, c.psi),
                                   q_full)
    p_keys = time_ms(torch, lambda: ksb.subband_keys_plain(c.spec, c.psi), 2)
    p_shrink = time_ms(torch, lambda: ksb.subband_shrink_plain(
        c.spec, c.psi, tau, "hard"), 2)
    out = {"subband_keys": (p1, p_keys,
                            bound(*rl.subband_keys_work(*case_support(c)))),
           "subband_shrink": (p2, p_shrink,
                              bound(*rl.subband_shrink_work(
                                  *case_support(c)))),
           "select_call": (selt, bound(*rl.select_work(b * nbands, h * w)))}
    print(f"band_percentile over the {nbands} bands of a call: "
          f"{selt:.3f} ms, bound {out['select_call'][1][0]:.4f} ms",
          flush=True)
    rows = box_percentile_passes(torch, ksb, kp, c, q_boxes)
    for name in ("box_keys", "box_shrink"):
        vals = rows[name]
        out[name] = (sum(v[0] for v in vals) / len(vals),
                     sum(v[1] for v in vals) / len(vals),
                     (sum(v[2][0] for v in vals) / len(vals), vals[0][2][1]))
    for name in ("subband_keys", "subband_shrink", "box_keys", "box_shrink"):
        ms, p_ms, bnd = out[name]
        print(f"{name} {b}x{h}x{w}: kernel passes {ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return out


def box_row_passes(index) -> tuple:
    """The trace names of the percentile route's box row passes, keys and
    shrink, in the form ``index`` plans: the general form's
    box_rows_kernel (PASS_KEYS = 2, PASS_SHRINK_RN = 1) or the pruned
    kernels."""
    if index.line is None:
        return "box_rows_kernel<2>", "box_rows_kernel<1>"
    return "box_keys_pruned_kernel", "box_shrink_pruned_kernel"


def box_percentile_passes(torch, ksb, kp, case, q_boxes) -> dict:
    """Time the percentile route's box passes on each box group of a
    SubbandCase (torch.profiler), in the form its indices plan, with each
    pass's rates, the plain versions (CUDA events) and each wrapper's
    bound (its inputs read and its outputs written once, the row pass's
    transforms in that form, ``roofline.box_row_flops``). Returns
    {"box_keys": [(ms, plain ms, bound)], "box_shrink": [...]} by
    group."""
    c = case
    b, h, w = c.b, c.h, c.w
    rl = roofline()
    lh = rl.line_flops(h)
    rows = {"box_keys": [], "box_shrink": []}
    for k, (_, lg, g) in enumerate(c.boxes):
        sel_b, args, index = c.box_args(k, "hard")
        args = args[:2] + (q_boxes[k],) + args[3:]
        side, sc = len(g.idx_h), len(g.idx_w)
        line = None if index.line is None else index.line[1]
        keys_pass, shrink_pass = box_row_passes(index)
        print(f"box group {c.basis} {side}x{sc} ({lg} bands): the "
              f"percentile route's row pass in the "
              f"{box_forms(ksb, index)[0][0]}", flush=True)

        def run_box():
            ksb.box_group_update_percentile(*args, "high", index=index)
        passes = (("box_cols_inverse_kernel", keys_pass) + SELECT_PASSES
                  + (shrink_pass, "box_cols_forward_kernel"))
        # one launch of each pass a call: a trace that dropped some of a
        # pass's launches is taken again
        bt = kernel_passes(torch, run_box, passes,
                           launches=dict.fromkeys(passes, 1))
        field = b * lg * sc * h * 8  # the scratch G, bytes
        col_flops = b * lg * sc * lh
        row_flops = b * lg * h * rl.box_row_flops(w, line)
        keys_b = b * lg * h * w * 4
        # the pruned form moves G's box columns once each way; the general
        # form's row pass gathers and scatters the same values
        print_passes(f"box_group_update[percentile] {b}x{side}x{sc}", bt, {
            "box_cols_inverse_kernel": (b * side * sc * 8 + field,
                                        col_flops),
            keys_pass: (field + keys_b, row_flops),
            **select_work(rl, kp, b * lg, h * w),
            shrink_pass: (2 * field, 2 * row_flops),
            "box_cols_forward_kernel": (field + b * side * sc * 8,
                                        col_flops)})
        box_tau = kp.band_percentile_plain(ksb.box_keys_plain(*args[:2],
                                                              *args[3:6]),
                                           q_boxes[k])
        p_bk = time_ms(torch, lambda: ksb.box_keys_plain(*args[:2],
                                                         *args[3:6]), 3)
        p_bs = time_ms(torch, lambda: ksb.box_group_update_plain(
            args[0], args[1], box_tau, *args[3:6], "hard"), 3)
        rows["box_keys"].append((
            bt["box_cols_inverse_kernel"] + bt[keys_pass], p_bk,
            bound(*rl.box_keys_work(b, lg, side, sc, h, w, line))))
        rows["box_shrink"].append((
            bt[shrink_pass] + bt["box_cols_forward_kernel"], p_bs,
            bound(*rl.box_shrink_work(b, lg, side, sc, h, w, line))))
        b_sel = sum(bt[n] for n in SELECT_PASSES)
        b_bnd = bound(*rl.select_work(b * lg, h * w))
        print(f"band_percentile over the {lg} bands of the {side}-side box "
              f"group: {b_sel:.3f} ms, bound {b_bnd[0]:.4f} ms", flush=True)
        for name in ("box_keys", "box_shrink"):
            ms, p_ms, bnd = rows[name][-1]
            print(f"{name} {c.basis} {b}x{side}x{sc} ({lg} bands): kernel "
                  f"passes {ms:.4f} ms, plain {p_ms:.3f} ms, bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return rows


@contextlib.contextmanager
def no_plain(ksb, kp):
    """Count every call of the percentile route's plain versions (and of
    the plain streamed apply) inside the block; yields the counts."""
    from pseudo_3d_interpolation_torch.ops import shearlet as sh

    calls = {}
    patched = [(ksb, name) for name in PLAIN_NAMES]
    patched += [(kp, "band_percentile_plain"),
                (sh, "_pocs_subband_apply_streamed")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched]

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def percentile_launches(ksb, basis: str, f: int) -> dict:
    """The launches of the percentile route on an ``f``-slice cube of the
    resident driver's batches: per batch and iteration, a subband_keys, a
    band_percentile and a subband_shrink for each band chunk of the batch,
    and a box_keys, a band_percentile and a box_shrink for each box
    group."""
    from pseudo_3d_interpolation_torch.models.transforms import get_transform
    from pseudo_3d_interpolation_torch.ops import shearlet as sh

    full, _, boxes = sh._plan_kernel_pack(get_transform(basis)._plan(N, N),
                                          N, N)
    from pseudo_3d_interpolation_torch.ops.kernels.subband import (
        band_chunks, row_support)
    offsets = row_support(full.psi)[0]
    sizes = [MAIN_BATCH] * (f // MAIN_BATCH) + ([f % MAIN_BATCH]
                                                 if f % MAIN_BATCH else [])
    chunks = sum(len(band_chunks(offsets, b, N, N)) - 1 for b in sizes)
    nb = len(boxes) * len(sizes)
    return {"subband_keys": chunks * NITER, "subband_shrink": chunks * NITER,
            "band_percentile": (chunks + nb) * NITER,
            "box_keys": nb * NITER, "box_shrink": nb * NITER}


def percentile_paths(torch, ksb, kp, Cube, truth, mask, cube, s_in,
                     production, dev, modules, trace_dir, part) -> dict:
    """Phase 17b: the SHEARLET and CURVELET cubes through ``interpolate``
    with ``device`` left to its default in phase 12d's configuration:
    route ``streamed-subband``, the split passes' and the selection's
    launches, no plain version called, a finite output (its SNR printed:
    in this configuration it does not beat the masked input's, in the
    JAX package either), and the first PCT_CHECK slices within SNR_TOL_DB
    of ``device="cpu"``. Returns {basis: launches}."""
    from pseudo_3d_interpolation_torch.models.pocs import (describe_route,
                                                           solver_route)
    from pseudo_3d_interpolation_torch.pipeline.pocs import (
        _production_transform, config_from_yaml, interpolate)

    prod = dataclasses.asdict(production)
    counts = {}
    for basis in ("SHEARLET", "CURVELET"):
        t_path = time.perf_counter()
        config = {"metadata": dict(prod, transform_kind=basis, **PCT_META)}
        cfg, extra = config_from_yaml(config)
        tr = _production_transform(cfg, extra)
        route = solver_route((MAIN_BATCH, N, N), (N, N), cfg, tr)
        print(f"phase 17b, {basis} hard-percentile: solver path "
              f"{describe_route(route)}; {tr}", flush=True)
        if route.route != "streamed-subband":
            fail(f"phase 17b {basis}: route {describe_route(route)}, not "
                 "streamed-subband")
        p_truth, p_cube, p_in = cut_to_fit(
            torch, interpolate, Cube, truth, mask, cube, s_in, config, dev,
            f"{basis} hard-percentile")
        want = percentile_launches(ksb, basis, p_truth.shape[0])
        # in this configuration neither package beats the masked input on
        # plane waves (the percentile falls to 60: 40% of every band's
        # coefficients kept); the first slices are held to the host below
        with no_plain(ksb, kp) as calls:
            _, got, _, _, _ = main_path(
                torch, interpolate, p_cube, config, dev, p_truth, p_in,
                f"{basis} hard-percentile main path", modules, want,
                default_device=True, beat_masked=False)
        if calls:
            fail(f"phase 17b {basis}: plain versions ran on the card's main "
                 f"path: {calls}")
        counts[basis] = got
        del p_cube
        first, _ = make_cube(torch, Cube, truth[:PCT_CHECK], mask)
        snrs, walls = [], []
        for where in (None, "cpu"):
            t0 = time.perf_counter()
            out = interpolate(first, config=config, device=where)
            walls.append(time.perf_counter() - t0)
            rec = out.data_vars["amp_interp"][1]
            snrs.append(snr_db(torch, truth[:PCT_CHECK], torch.from_numpy(
                np.moveaxis(rec, -1, 0)).to(dev)))
        print(f"phase 17b {basis}, first {PCT_CHECK} slices: SNR on the card "
              f"{snrs[0]:.3f} dB, device='cpu' {snrs[1]:.3f} dB (card "
              f"{walls[0]:.2f} s, cpu {walls[1]:.2f} s)", flush=True)
        if abs(snrs[0] - snrs[1]) > SNR_TOL_DB:
            fail(f"phase 17b {basis}: the card's SNR {snrs[0]:.3f} dB is not "
                 f"within {SNR_TOL_DB} dB of device='cpu''s {snrs[1]:.3f} dB")
        if trace_dir is not None:
            trace_main_path(torch, lambda: interpolate(part, config=config),
                            trace_dir, f"percentile_{basis.lower()}_trace")
        print(f"phase 17b {basis}: {time.perf_counter() - t_path:.1f} s",
              flush=True)
    return counts


# phase 18: the 1-D slice mesh on the one card
MESH_SHEARLET_SLICES = 2 * MAIN_BATCH + 1  # 18c: two batches and a tail


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (bound as port 0, then released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_call(torch, modules, label, single, sharded, equal):
    """Run ``single`` and then ``sharded``, each with every launch count
    set to 0 just before and read just after; fail unless the launches
    are the same and ``equal(single's result, sharded's)`` holds. Prints
    both walls and the launches."""
    walls, counts, outs = [], [], []
    for run in (single, sharded):
        torch.cuda.synchronize()
        reset_counts(*modules)
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(launch_counts(*modules))
    if counts[0] != counts[1]:
        fail(f"phase 18 {label}: launches {counts[1]} on the mesh, "
             f"{counts[0]} on one device")
    if not equal(*outs):
        fail(f"phase 18 {label}: the mesh's result differs from the "
             "single-device call's")
    print(f"phase 18 {label}: bit-equal to the single-device call, "
          f"launches { {k: v for k, v in counts[0].items() if v} } on "
          f"both; {walls[0]:.2f} s single, {walls[1]:.2f} s on the mesh",
          flush=True)


# 18e: a rank's batch on four cards (65 slices at batch 32 over 4 ranks)
MESH_CHECK_BATCH = MAIN_BATCH // 4
MESH_CHECK_GAP = 7.95e-3  # mesh_check.py's four-card SHEARLET gap (PERF.md §6)
# mesh_check.py's single-card call takes interpolate's default batch
MESH_CHECK_SINGLE = 64
# 18f: max|2-D mesh - one device| ≤ MESH_2D_TOL·max, or the SNRs within
# SNR_TOL_DB (mesh_check.py's rule)
MESH_2D_TOL = 1e-5


def cube_snr(torch, truth, amp) -> float:
    """SNR of a cube's (iline, xline, freq) result against the (f, h, w)
    truth."""
    return snr_db(torch, truth, torch.from_numpy(
        np.moveaxis(amp, -1, 0)).to(truth.device))


def batch_gap(torch, truth, part, config, interpolate):
    """18e: the SHEARLET cube ``part`` on one card at batch
    MESH_CHECK_BATCH against batch MAIN_BATCH (the mesh's batch, split
    four ways on four cards) and MESH_CHECK_SINGLE (mesh_check.py's
    single-card call): the max-normalised gaps and the SNRs, beside
    mesh_check.py's four-card gap. The same slices
    solved in smaller batches round their FFTs and sums otherwise, and a
    hard threshold flips where a coefficient sits at it: a gap of the
    four-card one's order shows that account; bit-equal results would
    point at the multi-rank path. Fails unless both SNRs agree within
    SNR_TOL_DB."""
    outs = {}
    for b in (MESH_CHECK_BATCH, MAIN_BATCH, MESH_CHECK_SINGLE):
        outs[b] = interpolate(part, config=config,
                              batch=b).data_vars["amp_interp"][1]
    a = outs[MESH_CHECK_BATCH]
    snr_a = cube_snr(torch, truth, a)
    for ref in (MAIN_BATCH, MESH_CHECK_SINGLE):
        b = outs[ref]
        gap = float(np.abs(a - b).max() / np.abs(b).max())
        snr_b = cube_snr(torch, truth, b)
        verdict = ("bit-equal: the batch does not explain mesh_check's gap"
                   if gap == 0.0 else "the same order as mesh_check's"
                   if 0.1 <= gap / MESH_CHECK_GAP <= 10.0 else
                   "not of mesh_check's order")
        print(f"phase 18 (e) SHEARLET cube of {len(part.coords['freq'])} on "
              f"one card, batch {MESH_CHECK_BATCH} against {ref}: max|d| "
              f"{gap:.3e} of max (mesh_check.py's four cards: "
              f"{MESH_CHECK_GAP:.2e}; {verdict}), SNR {snr_a:.3f} / "
              f"{snr_b:.3f} dB", flush=True)
        if abs(snr_a - snr_b) > SNR_TOL_DB:
            fail(f"phase 18 (e): batch {MESH_CHECK_BATCH} and {ref} reach "
                 f"{snr_a:.3f} and {snr_b:.3f} dB")


def mesh_2d_on_one_card(torch, dev, modules, production, truth, mask,
                        interpolate, Cube):
    """18f: ``make_mesh_2d(1, 1)`` on the world-size-1 group and the FFT
    cube's first MESH_SHEARLET_SLICES slices. ``interpolate`` on it splits
    no space axis, so it takes the 1-D slice path: bit-equal to the
    single-device call (the folded solve kernel) with the same launches.
    Then the space-sharded FFT solve (``SpaceShardedFFT`` over the mesh's
    space axis, the distributed line FFT a split space axis runs: PyTorch
    ops and no kernel) through ``interpolate_cube`` on the same slices,
    held to the single-device cube by SNR against the truth. Launches and
    walls printed."""
    from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib
    from pseudo_3d_interpolation_torch.parallel import solver

    mesh = mesh_lib.make_mesh_2d(1, 1)
    if mesh.shape != (1, 1) or mesh.device != dev or mesh.index != 0:
        fail(f"phase 18 (f): the 2-D mesh is {mesh}")
    part, _ = make_cube(torch, Cube, truth[:MESH_SHEARLET_SLICES], mask)
    obs = (truth[:MESH_SHEARLET_SLICES] * mask).cpu().numpy()
    line_fft = solver.SpaceShardedFFT(mesh.space)
    walls, outs, counts = [], [], []
    for run in (lambda: interpolate(part, config=production,
                                    batch=MAIN_BATCH
                                    ).data_vars["amp_interp"][1],
                lambda: interpolate(part, config=production, mesh=mesh,
                                    batch=MAIN_BATCH
                                    ).data_vars["amp_interp"][1],
                lambda: np.moveaxis(solver.interpolate_cube(
                    obs, mask.cpu().numpy(), production, transform=line_fft,
                    batch=MAIN_BATCH, device=dev)[0], 0, -1)):
        torch.cuda.synchronize()
        reset_counts(*modules)
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append({k: v for k, v in launch_counts(*modules).items()
                       if v})
    gap = float(np.abs(outs[2] - outs[0]).max() / np.abs(outs[0]).max())
    snrs = [cube_snr(torch, truth[:MESH_SHEARLET_SLICES], x) for x in outs]
    print(f"phase 18 (f) make_mesh_2d(1, 1): FFT cube of "
          f"{MESH_SHEARLET_SLICES}, single device {walls[0]:.2f} s "
          f"(launches {counts[0]}); the 2-D mesh of one space rank "
          f"{walls[1]:.2f} s (launches {counts[1]}), "
          f"{'bit-equal' if np.array_equal(outs[1], outs[0]) else 'DIFFERS'};"
          f" the space-sharded line FFT {walls[2]:.2f} s (launches "
          f"{counts[2]}), max|d| {gap:.3e} of max, SNR {snrs[2]:.3f} / "
          f"{snrs[0]:.3f} dB", flush=True)
    if not np.array_equal(outs[1], outs[0]) or counts[1] != counts[0]:
        fail("phase 18 (f): the 2-D mesh of one space rank is not the "
             f"single-device solve (launches {counts[1]} against "
             f"{counts[0]})")
    if counts[2]:
        fail(f"phase 18 (f): the space-sharded solve launched {counts[2]}")
    # both solves end at the float32 floor on these plane waves, where
    # the SNRs' difference measures rounding alone: there the elementwise
    # bound holds instead, as for pocs_solve in phase 3a
    if gap > MESH_2D_TOL and abs(snrs[0] - snrs[2]) > SNR_TOL_DB:
        fail(f"phase 18 (f): SNR {snrs[2]:.3f} dB through the space-"
             f"sharded line FFT against {snrs[0]:.3f} on one device, "
             f"max|d| {gap:.3e} of max")


def mesh_on_one_card(torch, dev, modules, production, truth, mask, cube):
    """Phase 18: a world-size-1 NCCL group (tcp://127.0.0.1 on a free
    port) and its mesh; (a) ``pocs_interpolate_sharded`` on phase 4's
    first batch, (b) ``interpolate(mesh=...)`` on the FFT cube, (c) on the
    SHEARLET cube's first MESH_SHEARLET_SLICES slices, (d)
    ``interpolate_time_cube_sharded`` on phase 11's preprocessed time cube
    against ``apply_fft`` -> ``interpolate`` -> ``apply_ifft``; each
    bit-equal to the single-device call with the same launches. The mesh
    holds one device: this shows the code path on the card, not
    collectives across cards. Then (e) the SHEARLET cube of (c) on one
    card at batch MESH_CHECK_BATCH (a rank's batch on four cards) against
    batches 32 and 64: the gaps beside mesh_check.py's four-card one; and
    (f) ``make_mesh_2d(1, 1)`` on the same group, the FFT cube's first
    MESH_SHEARLET_SLICES slices through it (the 1-D path, bit-equal) and
    through the space-sharded FFT solve (the distributed line FFT, PyTorch
    ops and no kernel) against the single-device folded solve
    (:func:`mesh_2d_on_one_card`)."""
    import torch.distributed as dist

    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.models.pocs import pocs_interpolate
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx
    from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib
    from pseudo_3d_interpolation_torch.parallel.solver import (
        pocs_interpolate_sharded)
    from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
    from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate
    from pseudo_3d_interpolation_torch.pipeline.preprocess import preprocess
    from pseudo_3d_interpolation_torch.pipeline.stage2 import (
        interpolate_time_cube_sharded)

    mesh_lib.initialize_distributed(coordinator=f"127.0.0.1:{free_port()}",
                                    num_processes=1, process_id=0,
                                    backend="nccl")
    try:
        mesh = mesh_lib.make_mesh()
        print(f"phase 18: a mesh of {mesh.size} device ({mesh.device}, "
              f"{dist.get_backend()}): the sharded code path on the card, "
              "not collectives across cards", flush=True)
        if mesh.size != 1 or mesh.device != dev:
            fail(f"phase 18: the mesh is {mesh}")

        obs = truth[:MAIN_BATCH] * mask
        z = Cplx(obs.real.contiguous(), obs.imag.contiguous())

        def results_equal(a, b):
            return all(torch.equal(x, y) for x, y in (
                (a.data.re, b.data.re), (a.data.im, b.data.im),
                (a.n_iterations, b.n_iterations), (a.cost, b.cost)))
        same_call(torch, modules, "(a) pocs_interpolate_sharded, FFT batch "
                  f"of {MAIN_BATCH}",
                  lambda: pocs_interpolate(z, mask, config=production),
                  lambda: pocs_interpolate_sharded(z, mask, mesh,
                                                   config=production),
                  results_equal)
        del z, obs

        def cubes_equal(a, b):
            return np.array_equal(a.data_vars["amp_interp"][1],
                                  b.data_vars["amp_interp"][1])
        same_call(torch, modules, f"(b) interpolate, FFT cube of {SLICES}",
                  lambda: interpolate(cube, config=production,
                                      batch=MAIN_BATCH),
                  lambda: interpolate(cube, config=production, mesh=mesh,
                                      batch=MAIN_BATCH), cubes_equal)
        shearlet = dataclasses.replace(production,
                                       transform_kind="SHEARLET")
        sh_part, _ = make_cube(torch, Cube, truth[:MESH_SHEARLET_SLICES],
                               mask)
        same_call(torch, modules, "(c) interpolate, SHEARLET cube of "
                  f"{MESH_SHEARLET_SLICES}",
                  lambda: interpolate(sh_part, config=shearlet,
                                      batch=MAIN_BATCH),
                  lambda: interpolate(sh_part, config=shearlet, mesh=mesh,
                                      batch=MAIN_BATCH), cubes_equal)
        batch_gap(torch, truth[:MESH_SHEARLET_SLICES], sh_part, shearlet,
                  interpolate)
        del sh_part
        mesh_2d_on_one_card(torch, dev, modules, production, truth, mask,
                            interpolate, Cube)

        truth_t, twt = chain_truth(torch, dev)
        fold = chain_fold()
        masked = (truth_t * torch.from_numpy(fold).to(dev)[..., None]).cpu(
            ).numpy()
        del truth_t
        pre = preprocess(time_cube(Cube, masked, fold, twt), balance="rms",
                         filter_type="bandpass", filter_freqs=CHAIN_BANDPASS)
        same_call(torch, modules, f"(d) interpolate_time_cube_sharded, "
                  f"{N}x{N}x{CHAIN_NS} time cube",
                  lambda: apply_ifft(interpolate(apply_fft(fresh(pre)))),
                  lambda: interpolate_time_cube_sharded(
                      fresh(pre), production, mesh=mesh),
                  lambda a, b: np.array_equal(a.data_vars["amp"][1],
                                              b.data_vars["amp"][1]))
    finally:
        dist.destroy_process_group()


# phase 20: the north-star runner on the card
NORTHSTAR = "examples/northstar_run_torch.py"
# a batch's launches on a 512² cube at the runner's 50 iterations: the
# SHEARLET solve's subband update once and its two box groups an
# iteration, the folded FFT solve once
NORTHSTAR_LAUNCHES = {"SHEARLET": {"subband_update": NITER,
                                   "box_group_update": 2 * NITER},
                      "FFT": {"pocs_solve[fft]": 1}}


def northstar(torch, modules):
    """Phase 20: the runner's cube built once (its wall printed), then
    ``run`` with the runner's defaults (512x512x1024, 50 iterations, keep
    0.5, batch 32) on SHEARLET and on FFT, every launch count set to 0
    just before each and read just after: the SHEARLET solve launches
    ``subband_update`` once and ``box_group_update`` twice a
    batch-iteration, the FFT solve ``pocs_solve[fft]`` once a batch, and
    no other kernel runs. The output must be finite, of the cube's shape,
    and beat the sparse cube's SNR. Returns {basis: the runner's
    report without its output}."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("northstar_torch",
                                                  NORTHSTAR)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    args = runner.parse_args([])
    t0 = time.perf_counter()
    cube = runner.synthetic_cube(*args.size, keep=args.keep)
    print(f"phase 20: the {'x'.join(map(str, args.size))} synthetic cube "
          f"built in {time.perf_counter() - t0:.2f} s on the host",
          flush=True)
    mesh = runner.make_mesh_for(None)
    batches = math.ceil((args.size[2] // 2 + 1) / args.batch)
    reports = {}
    for basis, per in NORTHSTAR_LAUNCHES.items():
        args = runner.parse_args(["--basis", basis])
        if args.niter != NITER:
            fail(f"phase 20: the runner's default niter is {args.niter}")
        want = dict.fromkeys(KERNELS, 0)
        want.update({k: batches * n for k, n in per.items()})
        torch.cuda.synchronize()
        reset_counts(*modules)
        t0 = time.perf_counter()
        report = runner.run(args, mesh, cube=cube, log=lambda line: print(
            f"phase 20 {basis}: {line}", flush=True))
        wall = time.perf_counter() - t0
        counts = launch_counts(*modules)
        out = report.pop("out")
        if counts != want:
            fail(f"phase 20 {basis}: kernel launches {counts} != {want}")
        if out.shape != tuple(args.size) or not np.isfinite(out).all():
            fail(f"phase 20 {basis}: output of shape {out.shape}, finite "
                 f"{bool(np.isfinite(out).all())}")
        del out
        if not report["snr_out"] > report["snr_in"]:
            fail(f"phase 20 {basis} did not improve SNR "
                 f"({report['snr_in']:.3f} -> {report['snr_out']:.3f} dB)")
        path = {k: v for k, v in counts.items() if v}
        print(f"phase 20 {basis}: launches {path}; solver stage "
              f"{report['solve_s']:.3f} s, {report['rate']:.1f} "
              f"slice-iterations/s; upload {report['upload_s']:.3f} s, "
              f"download {report['download_s']:.3f} s; device peak "
              f"{report['peak_gb']:.2f} GB; SNR {report['snr_in']:.3f} dB "
              f"sparse -> {report['snr_out']:.3f} dB; the call "
              f"{wall:.2f} s", flush=True)
        reports[basis] = report
    return reports


# phase 19: the SHEARLET split plan on the box kernel
SPLIT_THRESHOLD = 200  # 512²: only the finest scale (a 512 side) splits
SPLIT_GROUPS = [(2, 447, 126), (2, 126, 447), (1, 447, 63), (1, 63, 447)]
# rms of phase 19's noise floor beside plane waves of amplitude 0.5-2:
# the fine scale's narrow bands hold energy the thresholds keep
SPLIT_NOISE = 0.3


def split_plans(torch, ksb, kp, dev, modules) -> dict:
    """Phase 19: the 512² SHEARLET plan split at SPLIT_THRESHOLD (its
    finest scale re-grouped by each shear's exact support: box groups of
    447 x 126, 126 x 447, 447 x 63 and 63 x 447 with non-contiguous index
    lists, the rest zero-padded into the full-size bands), on plane
    waves with a noise floor of rms SPLIT_NOISE. (a) At batch 8
    and the main path's 32: subband_update and every box group, the split
    ones among them, against their plain versions, soft within SOFT_TOL
    and hard by iterate SNR; the percentile route's box_keys (within
    SOFT_TOL), the selection (bit-equal) and the split update (soft and
    hard) likewise. (b) ``pocs_subband_apply`` at 32x512² on the split
    plan against the box plan: its launches (no plain version may run),
    its time, and the result held to the box plan's (soft within
    SOFT_TOL; hard by the SNR of the POCS iterate within SNR_TOL_DB).
    (c) Each box group's time and bound at batch 32 (the split groups
    beside the box plan's two). (d) ``shearlet_transform`` and its
    inverse on the card against ``device="cpu"``, within 1e-5 of max.
    Returns the group times."""
    from pseudo_3d_interpolation_torch.models.transforms import get_transform
    from pseudo_3d_interpolation_torch.ops import shearlet as sh
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx

    err_a = err_b = err_keys = 0.0
    for b in (8, MAIN_BATCH):
        case = SubbandCase(torch, b, N, N, 1900 + b, dev,
                           split_threshold=SPLIT_THRESHOLD,
                           noise=SPLIT_NOISE)
        split = [(lg, len(g.idx_h), len(g.idx_w))
                 for _, lg, g in case.boxes if len(g.idx_h) != len(g.idx_w)]
        if split != SPLIT_GROUPS:
            fail(f"phase 19: the split plan's narrow box groups are {split}"
                 f", not {SPLIT_GROUPS}")
        print(f"19a split plan at {b}x{N}x{N}: {case.psi.shape[0]} full-size "
              f"bands, box groups "
              f"{[(lg, len(g.idx_h), len(g.idx_w)) for _, lg, g in case.boxes]}"
              f", perm {case.perm.tolist()[29:60]} (bands 29-59)", flush=True)
        ea, eb = subband_kernels_against_plain(torch, ksb, case,
                                               ("soft", "hard"), True)
        err_a, err_b = max(err_a, ea), max(err_b, eb)
        q_full, q_boxes = percentiles(torch, case)
        for k, (_, lg, g) in enumerate(case.boxes):
            _, args, index = case.box_args(k, "hard")
            work_b = torch.empty(ksb.box_work_floats(b, lg, len(g.idx_w), N),
                                 device=dev)
            got, hist_b = ksb.box_keys(args[0], args[1], args[3], N, N,
                                       index=index, work=work_b)
            histogram_against_plain(
                torch, kp, hist_b, got, f"19a box_keys {b}x{len(g.idx_h)}x"
                f"{len(g.idx_w)} of {lg} bands")
            plain = ksb.box_keys_plain(args[0], args[1], args[3], N, N)
            e = float(torch.max(torch.abs(got - plain)) / torch.max(plain))
            err_keys = max(err_keys, e)
            if e > SOFT_TOL:
                fail(f"19a box_keys {b}x{len(g.idx_h)}x{len(g.idx_w)}: "
                     f"max|d| {e:.2e} of max")
            selection_against_plain(torch, kp, got, q_boxes[k],
                                    f"19a split box group {len(g.idx_h)}x"
                                    f"{len(g.idx_w)} of {lg} bands", hist_b)
            del got, plain, work_b
        for op in ("soft", "hard"):
            ea, eb = percentile_against_plain(torch, ksb, case, op, q_full,
                                              q_boxes)
            err_a, err_b = max(err_a, ea), max(err_b, eb)
        if b == MAIN_BATCH:
            split_case = case
        else:
            del case
        torch.cuda.empty_cache()
    print(f"19a split plan against plain: largest max|d| subband "
          f"{err_a:.3e}, box groups {err_b:.3e} (absolute, on spectra), box "
          f"keys {err_keys:.2e} of max", flush=True)

    # (b) the whole apply on both plans at the main path's batch
    case = split_case
    box_plan = get_transform("SHEARLET")._plan(N, N)
    # the percentiles of phase 12d's decay of factors, canonical order
    q = get_transform("SHEARLET", precision="high").decay_from_input(
        case.x, "exponential", NITER, PCT_META["p_max"], PCT_META["p_min"],
        "factors")[TAU_ITER]
    inv = torch.argsort(case.perm)
    plans = {"box plan": (box_plan, case.tau[:, inv], q),
             "split plan": (sh.shearlet_plan(N, N,
                                             split_threshold=SPLIT_THRESHOLD),
                            case.tau, q[:, case.perm])}
    ops = ("soft", "hard", "hard-percentile")
    x = case.x
    outs, times, counts = {}, {}, {}
    for name, (plan, tau, q_plan) in plans.items():
        for op in ops:
            t = q_plan if op.endswith("-percentile") else tau
            with no_plain(ksb, kp) as calls:
                torch.cuda.synchronize()
                reset_counts(*modules)
                out = sh.pocs_subband_apply(x, plan, t, op, "high")
                torch.cuda.synchronize()
                counts[name, op] = {k: v for k, v in launch_counts(
                    *modules).items() if v}
            if calls:
                fail(f"19b {name} {op}: plain versions ran on the card: "
                     f"{calls}")
            outs[name, op] = torch.complex(out.re, out.im)
            times[name, op] = time_ms(torch, lambda: sh.pocs_subband_apply(
                x, plan, t, op, "high"), 5)
            print(f"19b pocs_subband_apply {MAIN_BATCH}x{N}x{N} {op} on the "
                  f"{name}: {times[name, op]:.3f} ms a call, launches "
                  f"{counts[name, op]}", flush=True)
    n_boxes = len(case.boxes)
    for op, wrappers in (("hard", ("box_group_update",)),
                         ("hard-percentile", ("box_keys", "box_shrink"))):
        got = counts["split plan", op]
        if any(got.get(w) != n_boxes for w in wrappers):
            fail(f"19b the split plan's {op} apply launched {got}, not "
                 f"{n_boxes} of each of {wrappers}")
    truth = case.truth

    def iterate_snr(acc_spatial):
        xr = acc_spatial * (1.0 - ALPHA * case.mask) + ALPHA * case.obs
        return snr_db(torch, truth, xr)
    for op in ops:
        a, bb = outs["split plan", op], outs["box plan", op]
        err = float(torch.max(torch.abs(a - bb)) / torch.max(torch.abs(bb)))
        snr_s, snr_b = iterate_snr(a), iterate_snr(bb)
        print(f"19b {op}: split plan against box plan max|d| {err:.2e} of "
              f"max, iterate SNR {snr_s:.3f} / {snr_b:.3f} dB", flush=True)
        if op == "soft" and err > SOFT_TOL:
            fail(f"19b soft: the split plan is {err:.2e} of max from the "
                 "box plan")
        if op != "soft" and abs(snr_s - snr_b) > SNR_TOL_DB:
            fail(f"19b {op}: iterate SNR {snr_s:.3f} vs {snr_b:.3f} dB")
    del outs

    # (c) each box group's time at the main path's batch, both plans
    groups = []
    box_case = SubbandCase(torch, MAIN_BATCH, N, N, 1900 + MAIN_BATCH, dev,
                           noise=SPLIT_NOISE)
    for label, c in (("box plan", box_case), ("split plan", case)):
        for k, (_, lg, g) in enumerate(c.boxes):
            t_k, t_p, bnd = time_box(torch, ksb, c, k)
            groups.append((label, lg, len(g.idx_h), len(g.idx_w), t_k, t_p,
                           bnd))
    print(f"19c box groups at batch {MAIN_BATCH} (plan, bands, sr x sc: "
          "kernel ms, plain ms, bound ms): " + "; ".join(
              f"{p}, {lg}, {sr}x{sc}: {t:.3f}, {tp:.3f}, {bd[0]:.4f}"
              for p, lg, sr, sc, t, tp, bd in groups), flush=True)
    # the percentile route's split box passes on the split groups
    rl = roofline()
    _, q_boxes = percentiles(torch, case)
    pct_groups = []
    for k, (_, lg, g) in enumerate(case.boxes):
        sr, sc = len(g.idx_h), len(g.idx_w)
        if sr == sc:
            continue
        _, args, index = case.box_args(k, "hard")
        args = args[:2] + (q_boxes[k],) + args[3:]
        t_k, t_p, _ = time_pair(
            torch, lambda: ksb.box_group_update_percentile(
                *args, "high", index=index),
            lambda: ksb.box_group_update_percentile_plain(*args), 3)
        line = None if index.line is None else index.line[1]
        keys_w = rl.box_keys_work(MAIN_BATCH, lg, sr, sc, N, N, line)
        shrink_w = rl.box_shrink_work(MAIN_BATCH, lg, sr, sc, N, N, line)
        sel_w = rl.select_work(MAIN_BATCH * lg, N * N)
        bnd = (bound(*keys_w)[0] + bound(*sel_w)[0] + bound(*shrink_w)[0],
               "bytes and operations")
        form = box_forms(ksb, index)[0][0]
        pct_groups.append((lg, sr, sc, t_k, t_p, bnd, form))
    print(f"19c percentile box route (box_keys + band_percentile + "
          f"box_shrink) at batch {MAIN_BATCH} on the split groups (bands, sr "
          "x sc, the row pass's form: kernel ms, plain ms, bound ms as the "
          "sum of the three): "
          + "; ".join(f"{lg}, {sr}x{sc}, {form}: {t:.3f}, {tp:.3f}, "
                      f"{bd[0]:.4f}"
                      for lg, sr, sc, t, tp, bd, form in pct_groups),
          flush=True)
    del box_case, case, split_case
    torch.cuda.empty_cache()

    # (d) the unplanned transform pair against the host
    psi = sh.shearlet_spectra(N, N)
    obs = plane_waves(torch, 2, N, N, 1990, dev)[0]
    z = Cplx(obs.real.contiguous(), obs.imag.contiguous())
    zc = Cplx(z.re.cpu(), z.im.cpu())
    for name, card, host in (
            ("shearlet_transform", lambda: sh.shearlet_transform(z, psi),
             lambda: sh.shearlet_transform(zc, psi)),
            ("inverse_shearlet_transform",
             lambda: sh.inverse_shearlet_transform(
                 sh.shearlet_transform(z, psi), psi),
             lambda: sh.inverse_shearlet_transform(
                 sh.shearlet_transform(zc, psi), psi))):
        got, want = card(), host()
        got = torch.complex(got.re, got.im).cpu()
        want = torch.complex(want.re, want.im)
        err = float(torch.max(torch.abs(got - want))
                    / torch.max(torch.abs(want)))
        print(f"19d {name} 2x{N}x{N} ({psi.shape[0]} bands): card against "
              f"device='cpu' max|d| {err:.2e} of max", flush=True)
        if not err <= 1e-5:
            fail(f"19d {name}: {err:.2e} of max from the host")
    back = sh.inverse_shearlet_transform(sh.shearlet_transform(z, psi), psi)
    err = float(torch.max(torch.abs(torch.complex(back.re, back.im) - obs))
                / torch.max(torch.abs(obs)))
    print(f"19d the pair reconstructs to {err:.2e} of max", flush=True)
    if not err <= 1e-5:
        fail(f"19d the unplanned pair reconstructs to {err:.2e} of max")
    return {"times": times, "groups": groups, "percentile": pct_groups}


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
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp
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
    kp._lib()
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
    rl = roofline()
    solve_bound = bound(*rl.solve_work(MAIN_BATCH, N, N, NITER, "fft"))
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
    iter_bound = bound(*rl.iteration_work(MAIN_BATCH, N, N))
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
    dct_bound = bound(*rl.solve_work(MAIN_BATCH, N, N, NITER, "dct"))
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
    # db4's filter length 8, level 3
    wv_bound = bound(*rl.solve_work(MAIN_BATCH, N, N, NITER, "wavelet",
                                    taps=8, level=3))
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
    modules = (ks, ksb, kp)
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
    t13f = time.perf_counter()
    segy_ibm_survey(torch, dev, modules)
    print(f"phase 13f: {time.perf_counter() - t13f:.1f} s", flush=True)
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

    with tempfile.TemporaryDirectory(prefix="p3d_stage1_") as tmp:
        # phase 15: stage 1, SEG-Y profiles repaired on the card
        t15 = time.perf_counter()
        try:
            stage1 = stage1_survey(torch, dev, modules, args.trace,
                                   pathlib.Path(tmp))
        except AssertionError as e:  # a repair or a card/host comparison
            import traceback

            traceback.print_exc()
            fail(f"phase 15: {e}")
        print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)

        # phase 16: the command line and the orchestrator on the card
        t16 = command_line(torch, dev, modules, stage1, pathlib.Path(tmp))
        print(f"phase 16: {t16:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # phase 17: SHEARLET and CURVELET with percentile thresholds, (a) the
    # split kernels and the selection against plain, (b) the cubes through
    # interpolate, on phase 4's cube made anew
    t17 = time.perf_counter()
    pct = percentile_kernels(torch, ksb, kp, dev)
    truth, mask = plane_waves(torch, SLICES, N, N, 0, dev)
    cube, s_in = make_cube(torch, Cube, truth, mask)
    part, _ = make_cube(torch, Cube, truth[:2 * MAIN_BATCH], mask)
    counts_pct = percentile_paths(torch, ksb, kp, Cube, truth, mask, cube,
                                  s_in, production, dev, modules, args.trace,
                                  part)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)

    # phase 18: the 1-D slice mesh on the one card
    t18 = time.perf_counter()
    mesh_on_one_card(torch, dev, modules, production, truth, mask, cube)
    print(f"phase 18: {time.perf_counter() - t18:.1f} s", flush=True)
    del truth, mask, cube, part
    torch.cuda.empty_cache()

    # phase 19: the SHEARLET split plan on the box kernel
    t19 = time.perf_counter()
    split_plans(torch, ksb, kp, dev, modules)
    print(f"phase 19: {time.perf_counter() - t19:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # phase 20: the north-star runner on the card
    t20 = time.perf_counter()
    northstar(torch, modules)
    print(f"phase 20: {time.perf_counter() - t20:.1f} s", flush=True)
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
    ] + [
        entry(name, replaces, counts_pct["SHEARLET"][name], err,
              *pct[name], "subband.cu")
        for name, replaces, err in (
            ("subband_keys", "subband.py:392", pct["err_keys"]),
            ("subband_shrink", "subband.py:392", pct["err_a"]),
            ("box_keys", "subband.py:316", pct["err_box_keys"]),
            ("box_shrink", "subband.py:316", pct["err_b"]))
    ] + [dict(entry("band_percentile", "", counts_pct["SHEARLET"][
        "band_percentile"], 0.0, pct["select"]["ms"],
        pct["select"]["plain_ms"], pct["select"]["bound"],
        "band_percentile.cu"), replaces="none: the JAX package takes this "
        "percentile in XLA (pseudo_3d_interpolation_tpu/ops/threshold.py:67"
        ")", library_ms=pct["select"]["library_ms"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
