"""Run the PyTorch port's 1-D slice mesh across the cards of one host and
hold it to one card.

Run from the root of a checkout, one process per card:

    torchrun --nproc-per-node=4 mesh_check.py [--only-2d]

(``--only-2d`` runs the 2 x 2 mesh's calls alone.)

Every rank joins the NCCL group (``parallel.mesh.initialize_distributed``
reads the variables ``torchrun`` sets), builds the same seeded inputs as
``chip_smoke.py`` and runs each call twice: alone on its own card, then
over the mesh of every rank. The calls: ``pocs_interpolate_sharded`` on a
batch of 32 slices of phase 4's 512x512 plane waves (FFT basis),
``pipeline.pocs.interpolate(mesh=...)`` on the 513-slice FFT cube and on
its first 65 slices as a SHEARLET cube, and
``pipeline.stage2.interpolate_time_cube_sharded`` on phase 11's
preprocessed 512x512x1024 time cube against ``apply_fft`` ->
``interpolate`` -> ``apply_ifft``. Each rank solves its slices with the
same kernels in smaller batches, so a sharded result must equal the
single-card one within 1e-5 of its largest value, or, for a cube of
plane waves, reach its SNR against the truth within 0.1 dB (the
production hard threshold flips coefficients at the threshold when the
batch's FFTs and reductions round differently). Last, the 2 x 2 slice x
space mesh (``make_mesh_2d(2, 2)``): the FFT cube's first 65 slices
through ``interpolate(mesh=...)``, each rank holding half the slices of
a batch and half the ilines of each, solved as a distributed line FFT
(PyTorch ops, one ``all_to_all_single`` over the space pair each way an
iteration), against the single-card folded solve by SNR; the same 65
slices as a SHEARLET and as a DCT cube, and the time cube through
``interpolate_time_cube_sharded``, which spread whole slices over the
mesh's four ranks: each against one card by the rule above and bit for
bit against ``make_mesh(4)``, the 1-D mesh of the same ranks, which runs
the same call last. Each call runs once
untimed first (kernel loading, the windows' plans). Rank 0 prints the
card's name and power limit, each call's walls, its own launches, the
difference and the SNRs; any failure exits non-zero on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

TOL = 1e-5  # max|mesh - one card| ≤ TOL·max|one card|, or
SNR_TOL_DB = 0.1  # the SNRs against the truth this close
SHEARLET_SLICES = 2 * cs.MAIN_BATCH + 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only-2d", action="store_true",
                        help="run the 2 x 2 slice x space mesh's calls "
                        "alone")
    args = parser.parse_args()
    import torch
    import torch.distributed as dist

    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.ops.kernels import _build
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp
    from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
    from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
    from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate

    if not torch.cuda.is_available():
        print("mesh_check: no CUDA card", file=sys.stderr)
        return 1
    mesh_lib.initialize_distributed(backend="nccl")
    mesh = mesh_lib.make_mesh()
    dev = mesh.device
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank0 = mesh.index == 0
    if rank0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        print(f"{len(smi)} cards: {smi[0]}; a mesh of {mesh.size} ranks, "
              f"{dist.get_backend()}", flush=True)
    _build.build()  # each rank (the builds are keyed and atomic)
    modules = (ks, ksb, kp)
    production = inspect.signature(interpolate).parameters["config"].default
    failures = []

    def launches():
        return {k: v for k, v in cs.launch_counts(*modules).items() if v}

    def check(label, single, sharded, arrays, truth=None, line=None):
        """Run both calls (the single one once untimed first), compare
        them, print rank 0's line. With ``line``, the same call on the
        1-D mesh of the same ranks runs last and must equal ``sharded``'s
        bit for bit."""
        single()
        walls, outs, counts = [], [], []
        for run in (single, sharded) + ((line,) if line else ()):
            torch.cuda.synchronize()
            dist.barrier()
            cs.reset_counts(*modules)
            t0 = time.perf_counter()
            outs.append(run())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(launches())
        a, b = (np.asarray(arrays(o)) for o in outs[:2])
        err = float(np.abs(a - b).max() / np.abs(a).max())
        snrs = ([cs.snr_db(torch, truth, torch.from_numpy(
            np.moveaxis(x, -1, 0)).to(dev)) for x in (a, b)]
                if truth is not None else None)
        same = line is None or np.array_equal(b, np.asarray(arrays(outs[2])))
        if rank0:
            print(f"{label}: max|d| {err:.2e} of max"
                  + (f", SNR {snrs[0]:.3f} / {snrs[1]:.3f} dB" if snrs
                     else "")
                  + f"; one card {walls[0]:.2f} s (launches {counts[0]}), "
                  f"mesh of {mesh.size} {walls[1]:.2f} s (rank 0's "
                  f"launches {counts[1]})"
                  + (f"; the 1-D mesh of its ranks {walls[2]:.2f} s "
                     f"(launches {counts[2]}), "
                     + ("bit-equal" if same else "DIFFERENT")
                     if line else ""), flush=True)
        if not (err <= TOL or (snrs is not None
                               and abs(snrs[0] - snrs[1]) <= SNR_TOL_DB)):
            failures.append(f"{label}: {err:.2e} of max")
        if not same:
            failures.append(f"{label}: differs from the 1-D mesh")

    truth, mask = cs.plane_waves(torch, cs.SLICES, cs.N, cs.N, 0, dev)
    truth_fft = truth[:SHEARLET_SLICES].clone()

    def amp(c):
        return c.data_vars["amp_interp"][1]
    if not args.only_2d:
        one_d_calls(torch, dev, mesh, production, truth, mask, check, amp)
    del truth

    mesh2 = mesh_lib.make_mesh_2d(2, 2)
    part, _ = cs.make_cube(torch, Cube, truth_fft, mask)
    check(f"interpolate on a 2x2 slice x space mesh, FFT cube of "
          f"{SHEARLET_SLICES}",
          lambda: interpolate(part, config=production, device=dev),
          lambda: interpolate(part, config=production, mesh=mesh2,
                              batch=cs.MAIN_BATCH), amp, truth_fft)
    line = mesh_lib.make_mesh(mesh2.size)
    for kind in ("SHEARLET", "DCT"):
        config = dataclasses.replace(production, transform_kind=kind)
        check(f"interpolate on a 2x2 slice x space mesh, {kind} cube of "
              f"{SHEARLET_SLICES} (whole slices over its grid)",
              lambda: interpolate(part, config=config, device=dev),
              lambda: interpolate(part, config=config, mesh=mesh2,
                                  batch=cs.MAIN_BATCH), amp, truth_fft,
              lambda: interpolate(part, config=config, mesh=line,
                                  batch=cs.MAIN_BATCH))
    del part, truth_fft
    pre = preprocessed_time_cube(torch, dev)
    stage2_check(pre, production, mesh2, check, line)
    del pre

    flags = torch.tensor([len(failures)], device=dev)
    dist.all_reduce(flags)
    dist.destroy_process_group()
    if rank0:
        verdict = "FAILED " + "; ".join(failures) if failures else "ok"
        print(f"mesh_check: {verdict} ({int(flags)} failures over the "
              "ranks)", flush=True)
    return 1 if int(flags) else 0


def one_d_calls(torch, dev, mesh, production, truth, mask, check, amp):
    """The 1-D mesh's calls: the FFT batch and cube, the SHEARLET cube of
    SHEARLET_SLICES and the sharded stage 2, each against one card."""
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.models.pocs import pocs_interpolate
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx
    from pseudo_3d_interpolation_torch.parallel.solver import (
        pocs_interpolate_sharded)
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate

    obs = truth[:cs.MAIN_BATCH] * mask
    z = Cplx(obs.real.contiguous(), obs.imag.contiguous())
    check(f"pocs_interpolate_sharded, FFT batch of {cs.MAIN_BATCH}",
          lambda: pocs_interpolate(z, mask, config=production),
          lambda: pocs_interpolate_sharded(z, mask, mesh,
                                           config=production),
          lambda r: torch.complex(r.data.re, r.data.im).cpu())
    cube, _ = cs.make_cube(torch, Cube, truth, mask)
    check(f"interpolate, FFT cube of {cs.SLICES}",
          lambda: interpolate(cube, config=production, device=dev),
          lambda: interpolate(cube, config=production, mesh=mesh,
                              batch=cs.MAIN_BATCH), amp, truth)
    shearlet = dataclasses.replace(production, transform_kind="SHEARLET")
    part, _ = cs.make_cube(torch, Cube, truth[:SHEARLET_SLICES], mask)
    check(f"interpolate, SHEARLET cube of {SHEARLET_SLICES}",
          lambda: interpolate(part, config=shearlet, device=dev),
          lambda: interpolate(part, config=shearlet, mesh=mesh,
                              batch=cs.MAIN_BATCH), amp,
          truth[:SHEARLET_SLICES])
    del z, cube, part

    stage2_check(preprocessed_time_cube(torch, dev), production, mesh,
                 check)


def preprocessed_time_cube(torch, dev):
    """Phase 11's 512x512x1024 time cube, masked and preprocessed on the
    card."""
    from pseudo_3d_interpolation_torch.io.cube import Cube
    from pseudo_3d_interpolation_torch.pipeline.preprocess import preprocess

    truth_t, twt = cs.chain_truth(torch, dev)
    fold = cs.chain_fold()
    masked = (truth_t * torch.from_numpy(fold).to(dev)[..., None]).cpu(
        ).numpy()
    del truth_t
    return preprocess(cs.time_cube(Cube, masked, fold, twt), balance="rms",
                      filter_type="bandpass", filter_freqs=cs.CHAIN_BANDPASS,
                      device=dev)


def stage2_check(pre, production, mesh, check, line=None):
    """``interpolate_time_cube_sharded`` on ``mesh`` against
    ``apply_fft`` -> ``interpolate`` -> ``apply_ifft`` on one card (and,
    with ``line``, bit for bit against the 1-D mesh of its ranks)."""
    from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
    from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft
    from pseudo_3d_interpolation_torch.pipeline.pocs import interpolate
    from pseudo_3d_interpolation_torch.pipeline.stage2 import (
        interpolate_time_cube_sharded)

    dev = mesh.device
    shape = "2x2 slice x space mesh, " if line is not None else ""
    check(f"interpolate_time_cube_sharded, {shape}{cs.N}x{cs.N}x"
          f"{cs.CHAIN_NS} time cube",
          lambda: apply_ifft(interpolate(
              apply_fft(cs.fresh(pre), device=dev), device=dev), device=dev),
          lambda: interpolate_time_cube_sharded(cs.fresh(pre), production,
                                                mesh=mesh),
          lambda c: c.data_vars["amp"][1], None,
          None if line is None else
          lambda: interpolate_time_cube_sharded(cs.fresh(pre), production,
                                                mesh=line))


if __name__ == "__main__":
    sys.exit(main())
