"""Time main paths of the PyTorch port several times in one process.

Run from the root of a checkout; the package and ``chip_smoke.py`` are
taken from the directory that holds this script:

    python3 cube_walls.py [--kind SHEARLET [CURVELET ...]] [--runs 3]
                          [--percentile] [--box-passes]

Drives ``pipeline.pocs.interpolate`` with its production defaults and
``transform_kind=KIND`` (each kind given, in turn) on ``chip_smoke.py``'s
512x512 frequency cube of 513 slices (plane waves under a 50% column
mask), after one untimed run on its first batch that builds the kernels
and warms the allocator. ``--percentile`` takes phase 12d's percentile
configuration on SHEARLET or CURVELET (``chip_smoke.PCT_META``: a hard
percentile threshold, the decay of factors from 99.9 to 60), as phase
17b does. Each run is checked as ``chip_smoke.py`` checks a main path
(kernel launches, a finite output, and an SNR better than the masked
input's where the configuration gives one) and prints its wall time and
SNR. ``--box-passes`` first times the percentile route's box passes on
the SHEARLET and CURVELET box groups at batch 32 (phase 17a's inputs):
each group's ``box_keys`` (the column pass and the row pass to the keys)
and ``box_shrink`` (the row pass and the summing column pass) in ms a
call, from torch.profiler, twice, with the form each group's row pass
took. Prints the card's name and power limit first. Two trees are
compared on one card by running a copy of this script from each,
alternating, in one command.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import math
import subprocess

import chip_smoke as cs

# the launches of one cube by transform: (kernel, launches per batch)
EXPECTED = {
    "FFT": {"pocs_solve[fft]": 1},
    "DCT": {"pocs_solve[dct]": 1},
    "SHEARLET": {"subband_update": cs.NITER, "box_group_update": 2 * cs.NITER},
    "CURVELET": {"subband_update": cs.NITER, "box_group_update": cs.NITER},
}
# the box passes of the percentile route by their kernels' names: the
# column passes, the general row pass (box_rows_kernel, PASS_KEYS = 2 and
# PASS_SHRINK_RN = 1) and the pruned one
BOX_KEYS = ("box_cols_inverse_kernel", "box_rows_kernel<2>",
            "box_keys_pruned_kernel")
BOX_SHRINK = ("box_rows_kernel<1>", "box_shrink_pruned_kernel",
              "box_cols_forward_kernel")


def box_passes(torch, ksb, dev):
    """Print box_keys and box_shrink of each 512² box group at batch 32,
    kernel ms a call (5 calls under the profiler, taken twice)."""
    for basis in ("SHEARLET", "CURVELET"):
        case = cs.SubbandCase(torch, cs.MAIN_BATCH, cs.N, cs.N,
                              1700 + cs.MAIN_BATCH, dev, basis)
        q_boxes = cs.percentiles(torch, case)[1]
        for k, (_, lg, g) in enumerate(case.boxes):
            _, args, index = case.box_args(k, "hard")
            args = args[:2] + (q_boxes[k],) + args[3:]
            line = getattr(index, "line", None)
            form = "general" if line is None else f"pruned, s'={line[1]}"

            def run():
                ksb.box_group_update_percentile(*args, "high", index=index)
            for take in (1, 2):
                t = cs.kernel_passes(torch, run, BOX_KEYS + BOX_SHRINK, 5,
                                     want=(BOX_KEYS[0], BOX_SHRINK[-1]))
                keys = sum(t[n] for n in BOX_KEYS)
                shrink = sum(t[n] for n in BOX_SHRINK)
                print(f"box passes {basis} {cs.MAIN_BATCH}x{len(g.idx_h)}x"
                      f"{len(g.idx_w)} ({lg} bands), {form}, take {take}: "
                      f"box_keys {keys:.4f} ms (row pass "
                      f"{keys - t[BOX_KEYS[0]]:.4f}), box_shrink "
                      f"{shrink:.4f} ms (row pass "
                      f"{shrink - t[BOX_SHRINK[-1]]:.4f})", flush=True)
        del case
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kind", choices=sorted(EXPECTED), nargs="+",
                        default=["SHEARLET"])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--percentile", action="store_true")
    parser.add_argument("--box-passes", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: no CUDA card")
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp
    from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
    from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    if args.box_passes:
        box_passes(torch, ksb, dev)
    production = inspect.signature(interpolate).parameters["config"].default
    truth, mask = cs.plane_waves(torch, cs.SLICES, cs.N, cs.N, 0, dev)
    cube, s_in = cs.make_cube(torch, Cube, truth, mask)
    first, _ = cs.make_cube(torch, Cube, truth[:cs.MAIN_BATCH], mask)
    batches = math.ceil(cs.SLICES / cs.MAIN_BATCH)
    for kind in args.kind:
        if args.percentile:
            if kind not in ("SHEARLET", "CURVELET"):
                cs.fail(f"--percentile takes SHEARLET or CURVELET, not {kind}")
            config = {"metadata": dict(dataclasses.asdict(production),
                                       transform_kind=kind, **cs.PCT_META)}
            expected = cs.percentile_launches(ksb, kind, cs.SLICES)
        else:
            config = dataclasses.replace(production, transform_kind=kind)
            expected = {k: v * batches for k, v in EXPECTED[kind].items()}
        interpolate(first, config=config, device=dev)
        label = f"{kind}{' hard-percentile' if args.percentile else ''} cube"
        for run in range(args.runs):
            cs.main_path(torch, interpolate, cube, config, dev, truth, s_in,
                         f"{label}, run {run + 1}", (ks, ksb, kp), expected,
                         beat_masked=not args.percentile)


if __name__ == "__main__":
    main()
