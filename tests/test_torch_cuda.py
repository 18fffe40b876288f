"""The CUDA solve kernel (pseudo_3d_interpolation_torch/csrc/pocs_solve.cu)
held against its plain PyTorch version on the card.

Every test here needs a CUDA card and skips without one; the kernel has no
CPU mode. The file imports no JAX, so on the machine with the card (which
has no jax) it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks

# soft thresholds are continuous in the coefficients: dense fp32 DFT
# products against cuFFT differ by rounding only
SOFT_TOL = 1e-4
# hard thresholds flip boundary coefficients under reordered arithmetic:
# compared by SNR against the truth
SNR_TOL_DB = 0.1
# the cost is (d/s)² with d = Σ|new| − Σ|x| a small difference of two
# float32 slice sums, so its relative error is amplified by s/d; sqrt(cost)
# carries the sums' rounding directly (measured 8e-8 at 512²)
SQRT_COST_ATOL = 1e-6


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, w, niter, device, seed=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((b, h, w), np.complex64)
    for i in range(b):
        for _ in range(4):
            fy, fx = rng.integers(1, 12, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 6.28))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=w) < 0.5)[None, :], (h, w)), np.float32)
    obs = (truth * mask).astype(np.complex64)
    amax = np.abs(np.fft.fft2(obs)).max(axis=(-2, -1))
    m = np.arange(niter, dtype=np.float64)[:, None] / max(niter - 1, 1)
    decay = (0.99 * amax[None] * np.exp(np.log(1e-3 / 0.99) * m))
    z = Cplx(torch.from_numpy(np.ascontiguousarray(obs.real)).to(device),
             torch.from_numpy(np.ascontiguousarray(obs.imag)).to(device))
    return (truth, z, torch.from_numpy(mask).to(device),
            torch.from_numpy(decay.astype(np.float32)).to(device))


def _host(z: Cplx) -> np.ndarray:
    return z.re.cpu().numpy() + 1j * z.im.cpu().numpy()


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("h,w", [(512, 512), (384, 512), (100, 130)])
def test_kernel_matches_plain(device, h, w, version, op):
    truth, z, mask, decay = _inputs(4, h, w, 10, device)
    before = ks.pocs_solve.launches
    res, cost = ks.pocs_solve(z, mask, decay, 0.75, op, version)
    ref, ref_cost = ks.pocs_solve_plain(z, mask, decay, 0.75, op, version)
    torch.cuda.synchronize()
    assert ks.pocs_solve.launches == before + 1
    got, want = _host(res), _host(ref)
    assert np.isfinite(got).all()
    if op == "hard":
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()
        np.testing.assert_allclose(np.sqrt(cost.cpu().numpy()),
                                   np.sqrt(ref_cost.cpu().numpy()),
                                   rtol=0, atol=SQRT_COST_ATOL)


@pytest.mark.cuda
def test_cube_drivers_agree_on_the_card(device):
    """The host-chunked driver, taken when a cube does not fit the card,
    gives the resident driver's result bit for bit on a cube stored
    (iline, xline, freq), which crosses in storage order."""
    from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
    from pseudo_3d_interpolation_torch.parallel import solver

    truth, _, mask, _ = _inputs(5, 128, 96, 8, device)
    m = mask.cpu().numpy()
    stored = np.ascontiguousarray(np.moveaxis(truth * m, 0, -1))
    view = np.moveaxis(stored, -1, 0)
    cfg = POCSConfig(niter=8, p_min="adaptive", version="fast", alpha=0.75)
    before = ks.pocs_solve.launches
    res = solver.interpolate_cube_resident(view, m, cfg, batch=2,
                                           device=device)
    chunked = solver.interpolate_cube(view, m, cfg, batch=2, device=device)
    assert ks.pocs_solve.launches == before + 6
    for a, b in zip(res, chunked):
        np.testing.assert_array_equal(a, b)
    assert _snr(truth, res[0]) > _snr(truth, view)
    assert solver.fits_resident(device, 5, 2, 128, 96)
    assert not solver.fits_resident(device, 10**6, 32, 512, 512)


@pytest.mark.cuda
def test_kernel_runs_zero_iterations_and_empty_batches(device):
    _, z, mask, decay = _inputs(2, 64, 64, 1, device)
    res, cost = ks.pocs_solve(z, mask, decay[:0])
    torch.cuda.synchronize()
    assert torch.equal(res.re, z.re) and torch.equal(res.im, z.im)
    assert torch.isinf(cost).all()
    empty = Cplx(z.re[:0], z.im[:0])
    res, cost = ks.pocs_solve(empty, mask, decay[:, :0])
    assert res.re.shape == (0, 64, 64) and cost.shape == (0,)
