"""SHEARLET against CURVELET on ``chip_smoke.py``'s plane-wave cube, in
both packages, on the CPU.

On the card the port's CURVELET cube (p_min 1e-3) ends 3.55 dB above its
SHEARLET cube (adaptive p_min). These tests run the production solve
(FPOCS, hard, exponential decay, alpha 0.75, 50 iterations, precision
'high') of both bases on the same plane waves through the JAX package and
the port, at the sizes the JAX CPU path affords, under SHEARLET's adaptive
p_min and under CURVELET's 1e-3 for both. Each of the port's SNRs is held
within 0.05 dB of the JAX package's, so the order of the two bases is the
reference's own. The printed SNRs are what PERF.md §7 cites."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pseudo_3d_interpolation_tpu.models import transforms as jtr
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops.cplx import Cplx

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

SNR_TOL_DB = 0.05
CONFIGS = (("SHEARLET", "adaptive"), ("SHEARLET", 1e-3), ("CURVELET", 1e-3))


def _snr(ref, x):
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2)
                               / np.sum(np.abs(ref - x) ** 2)))


def _solve_both(obs, mask, kind, p_min):
    jcfg = jpocs.POCSConfig(niter=50, thresh_op="hard",
                            thresh_model="exponential", p_min=p_min,
                            version="fast", alpha=0.75, eps=0.0,
                            transform_kind=kind)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(
        JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag)),
        jnp.asarray(mask), jtr.get_transform(kind, precision="high"), jcfg)
    res = pocs.pocs_interpolate(
        Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy())),
        torch.from_numpy(mask), get_transform(kind, precision="high"), cfg)
    return (np.asarray(jres.data.re) + 1j * np.asarray(jres.data.im),
            res.data.re.numpy() + 1j * res.data.im.numpy())


@pytest.mark.parametrize("n,slices", [(128, 4), (256, 2)])
def test_basis_order_on_the_plane_waves_is_the_reference_s(n, slices):
    truth, mask = chip_smoke.plane_waves(torch, slices, n, n, 0, "cpu")
    truth, mask = truth.numpy(), mask.numpy()
    obs = truth * mask
    snr = {}
    for kind, p_min in CONFIGS:
        want, got = _solve_both(obs, mask, kind, p_min)
        assert np.isfinite(got).all()
        snr[kind, p_min] = (_snr(truth, want), _snr(truth, got))
        print(f"{n}x{n}, {slices} slices, {kind} p_min {p_min}: SNR JAX "
              f"{snr[kind, p_min][0]:.3f} dB, port {snr[kind, p_min][1]:.3f}"
              f" dB (masked input {_snr(truth, obs):.3f} dB)")
        assert abs(snr[kind, p_min][1] - snr[kind, p_min][0]) < SNR_TOL_DB
    for shearlet in CONFIGS[:2]:
        lead = [snr["CURVELET", 1e-3][i] - snr[shearlet][i] for i in (0, 1)]
        assert np.sign(lead[0]) == np.sign(lead[1])
