"""How far the card's hard-percentile solve lands from the host's, seed by
seed, with the percentile route's box row pass in each form.

Run from the root of a checkout on a machine with a CUDA card:

    python3 percentile_seeds.py [--seeds 16]

For each seed, ``tests/test_torch_cuda.py``'s 128² case of
``test_percentile_solve_on_the_card_matches_the_host`` (two SHEARLET
slices, 15 FPOCS iterations, a hard percentile threshold falling from
99.9 to 60): the SNR against the truth of the solve on the card, with the
box row pass in the form its indices plan (pruned, ``box_line_plan``) and
in the general form, minus the SNR of the plain route on the host. A hard
threshold flips the coefficients that rounding moves across it, and in
this configuration a flip changes the rest of the solve, so the gap is a
distribution over seeds, not a rounding error. Then 4 slices of
``chip_smoke.py``'s 512² plane waves (seed 0) through ``interpolate`` in
phase 17b's configuration, card in both forms and host, as 17b holds its
cube's first slices. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=16)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("percentile_seeds.py: no CUDA card")
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    import test_torch_cuda as tc

    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.models.pocs import (POCSConfig,
                                                           pocs_interpolate)
    from pseudo_3d_interpolation_torch.ops import shearlet as sh
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx
    from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    plan_line = ksb.box_line_plan

    def take(form):
        """Plan the box groups' row pass in ``form`` from here on (the
        plans, and the box indices they carry, are built anew)."""
        ksb.box_line_plan = (plan_line if form == "pruned"
                             else lambda idx, n: None)
        sh.shearlet_plan.cache_clear()

    dev = torch.device("cuda")
    cfg = POCSConfig(niter=15, thresh_op="hard-percentile",
                     decay_kind="factors", p_max=99.9, p_min=60.0,
                     version="fast", alpha=0.75, transform_kind="SHEARLET")
    gaps = {"pruned": [], "general": []}
    try:
        for seed in range(args.seeds):
            truth, z, mask, _ = tc._inputs(2, 128, 128, 2, dev, seed)
            host = tc._snr(truth, tc._host(pocs_interpolate(
                Cplx(z.re.cpu(), z.im.cpu()), mask.cpu(), config=cfg).data))
            for form in gaps:
                take(form)
                card = tc._snr(truth, tc._host(
                    pocs_interpolate(z, mask, config=cfg).data))
                gaps[form].append(card - host)
            print(f"seed {seed}: SNR card - host, pruned "
                  f"{gaps['pruned'][-1]:+.4f} dB, general "
                  f"{gaps['general'][-1]:+.4f} dB", flush=True)
        for form, g in gaps.items():
            g = np.abs(g)
            print(f"{form}: |SNR card - host| median {np.median(g):.4f} dB, "
                  f"max {g.max():.4f} dB, {int((g > tc.SNR_TOL_DB).sum())} "
                  f"of {len(g)} seeds over {tc.SNR_TOL_DB} dB", flush=True)
        production = inspect.signature(interpolate).parameters[
            "config"].default
        config = {"metadata": dict(dataclasses.asdict(production),
                                   transform_kind="SHEARLET", **cs.PCT_META)}
        truth, mask = cs.plane_waves(torch, cs.PCT_CHECK, cs.N, cs.N, 0, dev)
        first, _ = cs.make_cube(torch, Cube, truth, mask)
        snrs = {}
        for where in ("pruned", "general", "cpu"):
            take("pruned" if where == "cpu" else where)
            out = interpolate(first, config=config,
                              device="cpu" if where == "cpu" else None)
            rec = np.moveaxis(out.data_vars["amp_interp"][1], -1, 0)
            snrs[where] = cs.snr_db(torch, truth,
                                    torch.from_numpy(rec).to(dev))
        print(f"{cs.PCT_CHECK} slices of {cs.N}x{cs.N} plane waves, SHEARLET "
              "in phase 17b's configuration: SNR " + ", ".join(
                  f"{k} {v:.4f} dB" for k, v in snrs.items()), flush=True)
    finally:
        take("pruned")


if __name__ == "__main__":
    main()
