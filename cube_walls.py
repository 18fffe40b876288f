"""Time one main path of the PyTorch port several times in one process.

Run from the root of a checkout; the package and ``chip_smoke.py`` are
taken from the directory that holds this script:

    python3 cube_walls.py [--kind SHEARLET] [--runs 3]

Drives ``pipeline.pocs.interpolate`` with its production defaults and
``transform_kind=KIND`` on ``chip_smoke.py``'s 512x512 frequency cube of
513 slices (plane waves under a 50% column mask), after one untimed run
on its first batch that builds the kernels and warms the allocator. Each
run is checked as ``chip_smoke.py`` checks a main path (kernel launches,
a finite output, an SNR better than the masked input's) and prints its
wall time and SNR. Prints the card's name and power limit first. Two
trees are compared on one card by running a copy of this script from
each, alternating, in one session.
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
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kind", choices=sorted(EXPECTED),
                        default="SHEARLET")
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: no CUDA card")
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
    from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    production = inspect.signature(interpolate).parameters["config"].default
    config = dataclasses.replace(production, transform_kind=args.kind)
    truth, mask = cs.plane_waves(torch, cs.SLICES, cs.N, cs.N, 0, dev)
    cube, s_in = cs.make_cube(torch, Cube, truth, mask)
    first, _ = cs.make_cube(torch, Cube, truth[:cs.MAIN_BATCH], mask)
    interpolate(first, config=config, device=dev)
    batches = math.ceil(cs.SLICES / cs.MAIN_BATCH)
    expected = {k: v * batches for k, v in EXPECTED[args.kind].items()}
    for run in range(args.runs):
        cs.main_path(torch, interpolate, cube, config, dev, truth, s_in,
                     f"{args.kind} cube, run {run + 1}", (ks, ksb), expected)


if __name__ == "__main__":
    main()
