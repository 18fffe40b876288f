"""Precision 'default' on every basis and route of the port: each of the
five bases through ``models.pocs.pocs_interpolate`` on the CPU at
precision 'default', at eps 0 (the folded kernels' plain versions, or the
directional scan) and at eps 1e-2 (the per-iteration FFT route and the
plain scan), against the JAX package (its Pallas kernels in interpret
mode, whose 'default' is an fp32 product on the CPU), and bit for bit
against the port's own 'highest': every precision name computes in full
fp32. The kernel wrappers take 'default' too and refuse an unknown name.

Tolerances, as the existing tests of each basis hold it: soft thresholds
move the result by float32 rounding only, max|Δ| ≤ 1e-4·max|JAX|."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

SOFT_TOL = 1e-4
BASES = ("FFT", "DCT", "WAVELET", "SHEARLET", "CURVELET")
BASE = dict(niter=6, thresh_op="soft", thresh_model="exponential",
            p_max=0.99, p_min=1e-3, alpha=0.75, version="fast",
            use_pallas=True, pallas_interpret=True)
# the route each basis takes at eps 0 and at eps 1e-2
ROUTES = {("FFT", 0.0): "fused-folded", ("FFT", 1e-2): "fused-periter",
          ("DCT", 0.0): "fused-folded", ("DCT", 1e-2): "xla-scan",
          ("WAVELET", 0.0): "fused-folded", ("WAVELET", 1e-2): "xla-scan",
          ("SHEARLET", 0.0): "streamed-subband",
          ("SHEARLET", 1e-2): "streamed-subband",
          ("CURVELET", 0.0): "streamed-subband",
          ("CURVELET", 1e-2): "streamed-subband"}


def _truth(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((b, h, w), np.complex64)
    for i in range(b):
        for _ in range(3):
            fy, fx = rng.integers(1, 8, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 6.28))
    cols = (rng.uniform(size=w) < 0.5).astype(np.float32)
    return truth, np.ascontiguousarray(np.broadcast_to(cols, (h, w)))


def _pair(a):
    return Cplx(torch.from_numpy(np.ascontiguousarray(a.real, np.float32)),
                torch.from_numpy(np.ascontiguousarray(a.imag, np.float32)))


def _np(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


@pytest.mark.parametrize("eps", [0.0, 1e-2])
@pytest.mark.parametrize("kind", BASES)
def test_default_precision_matches_jax_and_highest(kind, eps):
    truth, mask = _truth(2, 64, 64, seed=BASES.index(kind))
    obs = truth * mask
    jcfg = jpocs.POCSConfig(**dict(BASE, transform_kind=kind, eps=eps))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(
        JCplx(jnp.asarray(obs.real, jnp.float32),
              jnp.asarray(obs.imag, jnp.float32)),
        jnp.asarray(mask), jget(kind, precision="default"), jcfg)
    tr = get_transform(kind, precision="default")
    assert pocs.solver_route((2, 64, 64), (64, 64), cfg, tr).route == \
        ROUTES[(kind, eps)]
    res = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask), tr, cfg)
    got, want = _np(res.data), _np(jres.data)
    assert np.isfinite(got).all()
    d = np.abs(got - want).max()
    assert d <= SOFT_TOL * np.abs(want).max(), d / np.abs(want).max()
    # every precision name is full fp32 in the port
    high = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask),
                                 get_transform(kind, precision="highest"),
                                 cfg)
    assert torch.equal(res.data.re, high.data.re)
    assert torch.equal(res.data.im, high.data.im)


def test_kernel_wrappers_take_default_and_refuse_unknown_names():
    z = Cplx(torch.ones(2, 16, 16), torch.zeros(2, 16, 16))
    mask = torch.ones(16, 16)
    decay = torch.ones(3, 2)
    out = {p: ks.pocs_solve(z, mask, decay, precision=p)[0]
           for p in ("default", "high")}
    assert torch.equal(out["default"].re, out["high"].re)
    it = {p: ks.pocs_iteration(z, z, mask, torch.ones(2), precision=p)
          for p in ("default", "highest")}
    assert torch.equal(it["default"].re, it["highest"].re)
    for bad in ("fastest", "bf16"):
        with pytest.raises(ValueError, match="unknown precision"):
            ks.pocs_solve(z, mask, decay, precision=bad)
        with pytest.raises(ValueError, match="unknown precision"):
            ksb._op("hard", bad)
    assert ksb._op("hard", "default") == "hard"
