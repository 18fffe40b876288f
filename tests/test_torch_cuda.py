"""The CUDA kernels (pseudo_3d_interpolation_torch/csrc/pocs_solve.cu: the
FFT, DCT and WAVELET solves and the FFT iteration; csrc/subband.cu: the
subband update, spectral and spatial, their line engine
csrc/fft_lines.cuh, the box group update, and the percentile route's split
passes; csrc/band_percentile.cu: the per-band selection) held against
their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one; the kernels have
no CPU mode. The file imports no JAX, so on the machine with the card (which
has no jax) it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from torch_helpers import gap_taus

from pseudo_3d_interpolation_torch.ops import curvelet as cv
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops import wavelet as wv
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb

# soft thresholds are continuous in the coefficients: the kernels' fp32
# sums against cuFFT and cuBLAS differ by rounding only
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
    before = ks.pocs_solve.launches_by_basis["fft"]
    res, cost = ks.pocs_solve(z, mask, decay, 0.75, op, version)
    ref, ref_cost = ks.pocs_solve_plain(z, mask, decay, 0.75, op, version)
    torch.cuda.synchronize()
    assert ks.pocs_solve.launches_by_basis["fft"] == before + 1
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
@pytest.mark.parametrize("niter", [1, 6])
@pytest.mark.parametrize("h,w", [(512, 512), (384, 512), (100, 130),
                                 (60, 2048)])
def test_solve_cost_sums_match_plain(device, h, w, niter):
    """The FFT solve's cost from the partial sums of its row blocks (8 rows
    of 512 at 512², 16 rows at 100×130 with a short last block, one row at
    2048 wide) against the plain version's, to √cost 1e-6; the workspace
    the wrapper allocates is the one the budget counts."""
    _, z, mask, decay = _inputs(3, h, w, niter, device, seed=h + w)
    _, cost = ks.pocs_solve(z, mask, decay, 0.75, "soft", "fast")
    _, ref_cost = ks.pocs_solve_plain(z, mask, decay, 0.75, "soft", "fast")
    torch.cuda.synchronize()
    np.testing.assert_allclose(np.sqrt(cost.cpu().numpy()),
                               np.sqrt(ref_cost.cpu().numpy()),
                               rtol=0, atol=SQRT_COST_ATOL)
    for code, basis in enumerate(ks.BASES):
        assert ks._lib().p3d_pocs_solve_work_floats(
            3, h, w, code) == ks.solve_work_floats(3, h, w, basis)


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
    before = ks.pocs_solve.launches_by_basis["fft"]
    res = solver.interpolate_cube_resident(view, m, cfg, batch=2,
                                           device=device)
    chunked = solver.interpolate_cube(view, m, cfg, batch=2, device=device)
    assert ks.pocs_solve.launches_by_basis["fft"] == before + 6
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


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("h,w", [(512, 512), (384, 512), (100, 130),
                                 (8, 4096), (4096, 16)])
def test_iteration_kernel_matches_plain(device, h, w, op):
    """One FFT-basis iteration on the line passes, up to the engine's
    longest line (4096) along either side; the hard threshold on taus away
    from every spectral magnitude (``gap_taus``), so all three are held to
    1e-4."""
    truth, z, mask, decay = _inputs(4, h, w, 10, device)
    x = Cplx(z.re * 1.5 + 0.1, z.im - 0.2)
    tau = decay[3].contiguous()
    if op == "hard":
        mags = np.abs(np.fft.fft2(_host(x).astype(np.complex128)))
        tau = torch.from_numpy(gap_taus(mags.reshape(4, 1, -1))[:, 0]).to(
            device)
    before = ks.pocs_iteration.launches
    got = ks.pocs_iteration(x, z, mask, tau, 0.75, op)
    want = ks.pocs_iteration_plain(x, z, mask, tau, 0.75, op)
    torch.cuda.synchronize()
    assert ks.pocs_iteration.launches == before + 1
    got, want = _host(got), _host(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
def test_iteration_kernel_refuses_a_side_past_the_longest_line(device):
    _, z, mask, decay = _inputs(1, 8, 4097, 1, device)
    before = ks.pocs_iteration.launches
    with pytest.raises(ValueError, match="longer than 4096"):
        ks.pocs_iteration(z, z, mask, decay[0])
    assert ks.pocs_iteration.launches == before


def _basis_decay(z: Cplx, basis: str, niter: int, wavelet=None):
    """The exponential schedule of the basis' own coefficients (p_min
    1e-3): (niter, B), or (niter, B, 3·level) for the wavelet."""
    from pseudo_3d_interpolation_torch.models.transforms import get_transform

    tr = get_transform(basis.upper(), **({"wavelet": wavelet, "level": 3}
                                         if wavelet else {}))
    if wavelet:
        tr = tr.with_shape(z.shape)
    d = tr.decay(tr.forward(z), "exponential", niter, 0.99, 1e-3, "values")
    if wavelet:
        d = torch.stack([leaf for det in d[1:] for leaf in det], dim=-1)
    return d.contiguous()


def _check_solve(truth, z, mask, decay, op, version, **kw):
    before = ks.pocs_solve.launches_by_basis[kw["basis"]]
    res, cost = ks.pocs_solve(z, mask, decay, 0.75, op, version, **kw)
    ref, ref_cost = ks.pocs_solve_plain(z, mask, decay, 0.75, op, version,
                                        **kw)
    torch.cuda.synchronize()
    assert ks.pocs_solve.launches_by_basis[kw["basis"]] == before + 1
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
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("h,w", [(512, 512), (384, 512), (100, 130),
                                 (97, 130), (8, 4096), (4096, 16)])
def test_dct_kernel_matches_plain(device, h, w, version, op):
    """The DCT solve's line passes with Makhoul's steps: powers of two
    (the register FFT), 384, and sides of the direct DFT, odd ones too;
    up to the engine's longest line (4096) along either side, where a
    column block holds its three 4096-entry twiddle tables."""
    truth, z, mask, _ = _inputs(4, h, w, 10, device)
    _check_solve(truth, z, mask, _basis_decay(z, "dct", 10), op, version,
                 basis="dct")


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["fft", "dct"])
def test_line_solves_refuse_a_side_past_the_longest_line(device, basis):
    _, z, mask, decay = _inputs(1, 8, 4097, 1, device)
    before = ks.pocs_solve.launches_by_basis[basis]
    with pytest.raises(ValueError, match="longer than 4096"):
        ks.pocs_solve(z, mask, decay, basis=basis)
    assert ks.pocs_solve.launches_by_basis[basis] == before


@pytest.mark.cuda
def test_dct_solve_runs_the_line_passes_and_no_gemm(device):
    """A DCT solve's profile: the three line passes and the state kernel
    an iteration, and no dense product (``gemm`` in a kernel's name)."""
    from torch.profiler import ProfilerActivity, profile

    _, z, mask, _ = _inputs(2, 128, 96, 3, device)
    decay = _basis_decay(z, "dct", 3)
    ks.pocs_solve(z, mask, decay, basis="dct")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ks.pocs_solve(z, mask, decay, basis="dct")
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "gemm" in n.lower()], names
    for kernel in ("solve_rows_forward_kernel", "solve_cols_shrink_kernel",
                   "solve_rows_inverse_kernel", "state_kernel"):
        calls = sum(e.count for e in prof.key_averages() if kernel in e.key)
        assert calls == 3, (kernel, names)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("n,name", [(512, "db4"), (512, "coif5"),
                                    (96, "db4"), (160, "db20"),
                                    (512, "db20")])
def test_wavelet_kernel_matches_plain(device, n, name, version, op):
    """The Mallat cascade at level 3 as filter passes; 96² has blocks of
    96, 48 and 24, whose tiles overhang; db20 at 160² has a deepest block
    of 40 = L, which a tile's region wraps more than twice."""
    truth, z, mask, _ = _inputs(4, n, n, 10, device)
    mats = [wv.dwt_matrix(n >> j, name) for j in range(3)]
    _check_solve(truth, z, mask, _basis_decay(z, "wavelet", 10, name), op,
                 version, basis="wavelet", wavelet_mats=mats)


@pytest.mark.cuda
def test_wavelet_kernel_keeps_the_band_order(device):
    """One regular iteration with a distinct soft threshold per band: the
    kernel's quadrant map against the plain map."""
    truth, z, mask, _ = _inputs(2, 256, 256, 1, device)
    d = _basis_decay(z, "wavelet", 1, "db4")
    d = d * torch.linspace(0.2, 1.0, d.shape[-1], device=device)
    mats = [wv.dwt_matrix(256 >> j, "db4") for j in range(3)]
    _check_solve(truth, z, mask, d.contiguous(), "soft", "regular",
                 basis="wavelet", wavelet_mats=mats)


@pytest.mark.cuda
def test_new_kernels_take_empty_batches(device):
    _, z, mask, decay = _inputs(1, 64, 64, 2, device)
    empty = Cplx(z.re[:0], z.im[:0])
    out = ks.pocs_iteration(empty, empty, mask, decay[0, :0])
    assert out.re.shape == (0, 64, 64)
    res, cost = ks.pocs_solve(empty, mask, decay[:, :0], basis="dct")
    assert res.re.shape == (0, 64, 64) and cost.shape == (0,)
    mats = [wv.dwt_matrix(64 >> j, "db4") for j in range(2)]
    res, cost = ks.pocs_solve(empty, mask, torch.zeros(2, 0, 6,
                                                       device=device),
                              basis="wavelet", wavelet_mats=mats)
    assert res.re.shape == (0, 64, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,change,counter", [
    ("FFT", {"eps": 1e-16}, "iteration"),
    ("DCT", {}, "dct"),
    ("WAVELET", {"p_min": 1e-5}, "wavelet")])
def test_new_routes_on_the_card_match_the_host(device, kind, change, counter):
    """``pocs_interpolate`` on each new route, on the card through its
    kernel and on the host through the plain versions (soft thresholds):
    one launch per iteration (per-iteration route) or per batch."""
    import dataclasses

    from pseudo_3d_interpolation_torch.models.pocs import (POCSConfig,
                                                           pocs_interpolate)

    truth, z, mask, _ = _inputs(3, 256, 256, 8, device)
    cfg = dataclasses.replace(
        POCSConfig(niter=8, thresh_op="soft", p_min="adaptive",
                   version="fast", alpha=0.75, transform_kind=kind),
        **change)
    ks.reset_launches()
    res = pocs_interpolate(z, mask, config=cfg)
    torch.cuda.synchronize()
    launches = (ks.pocs_iteration.launches if counter == "iteration"
                else ks.pocs_solve.launches_by_basis[counter])
    assert launches == (8 if counter == "iteration" else 1)
    host = pocs_interpolate(Cplx(z.re.cpu(), z.im.cpu()), mask.cpu(),
                            config=cfg)
    got, want = _host(res.data), _host(host.data)
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()
    assert res.n_iterations.tolist() == host.n_iterations.tolist()
    assert _snr(truth, got) > _snr(truth, _host(z))


def _slices(b, h, w, device, seed):
    """Random (b, h, w) slices on the card and their spectra."""
    rng = np.random.default_rng(seed)
    x = Cplx(*(torch.from_numpy(rng.normal(size=(b, h, w)).astype(
        np.float32)).to(device) for _ in range(2)))
    xf = torch.fft.fft2(torch.complex(x.re, x.im))
    return x, Cplx(xf.real.contiguous(), xf.imag.contiguous())


def _taus(z: Cplx, plan):
    """Per-subband thresholds at 30% of each subband's largest
    coefficient, from the streamed statistics of the slices."""
    amax, _ = sh.subband_stats(z, plan)
    return (0.3 * amax).contiguous()


def _tau_for(op, plain_taus, mags):
    if op != "hard":
        return plain_taus
    return torch.from_numpy(gap_taus(mags())).to(plain_taus.device)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("h,w", [(128, 128), (384, 512), (96, 80)])
def test_subband_kernel_matches_plain(device, h, w, op):
    """Kernel A on power-of-two and other sides, within 1e-4 of max (fp32
    FFTs in another order); the hard threshold on taus away from every
    coefficient (``gap_taus``)."""
    plan = sh.shearlet_plan(h, w)
    full, full_idx, _ = sh._plan_kernel_pack(plan, h, w)
    x, spec = _slices(3, h, w, device, 4)
    psi = full.psi_on(device)

    def mags():
        xf = _host(spec).astype(np.complex128)
        c = np.fft.ifft2(xf[:, None] * full.psi.astype(np.float64)[None])
        return np.abs(c).reshape(c.shape[0], c.shape[1], -1)

    tau = _tau_for(op, _taus(x, plan)[:, torch.from_numpy(full_idx).to(
        device)].contiguous(), mags)
    before = ksb.subband_update.launches
    got = ksb.subband_update(spec, psi, tau, op,
                             support=full.support_on(device))
    want = ksb.subband_update_plain(spec, psi, tau, op)
    torch.cuda.synchronize()
    assert ksb.subband_update.launches == before + 1
    got, want = _host(got), _host(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


def _check_box_groups(device, plan, h, w, op, boxes, b=4):
    """Kernel B against plain on every box group of ``plan`` on an h × w
    grid at batch b, within 1e-4 of max; the hard threshold on taus away
    from every coefficient."""
    x, spec = _slices(b, h, w, device, 5)
    tau = _taus(x, plan)
    for l0, lg, g in boxes:
        ih, iw = g.index_on(device)
        xbox = Cplx(spec.re[:, ih[:, None], iw[None, :]].contiguous(),
                    spec.im[:, ih[:, None], iw[None, :]].contiguous())
        mats = g.box_mats_on(h, w, device)

        def mags():
            ah, aw = (np.asarray(m.cpu(), np.float64) for m in mats[::2])
            ah = ah + 1j * np.asarray(mats[1].cpu(), np.float64)
            aw = aw + 1j * np.asarray(mats[3].cpu(), np.float64)
            v = _host(xbox)[:, None] * g.psi.astype(np.float64)[None]
            c = ah.conj().T @ v @ aw.conj() / (h * w)
            return np.abs(c).reshape(c.shape[0], c.shape[1], -1)

        group_tau = _tau_for(op, tau[:, l0:l0 + lg].contiguous(), mags)
        args = (xbox, g.psi_on(device), group_tau, mats, h, w, op)
        before = ksb.box_group_update.launches
        got = ksb.box_group_update(*args, index=g.box_index_on(h, w, device))
        want = ksb.box_group_update_plain(*args)
        torch.cuda.synchronize()
        assert ksb.box_group_update.launches == before + 1
        got, want = _host(got), _host(want)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("h,w,b", [(256, 256, 4), (512, 512, 4),
                                   (384, 512, 4), (100, 130, 4),
                                   (512, 512, 32)])
def test_box_kernel_matches_plain(device, h, w, b, op):
    """Kernel B on the box groups of the shearlet plan (16- and 40-side
    boxes; at 100×130 the 16-side box alone, on the direct-DFT lines of
    the odd grid), at batch 4 and at the main path's 32."""
    plan = sh.shearlet_plan(h, w)
    _, _, boxes = sh._plan_kernel_pack(plan, h, w)
    assert [len(g.idx_h) for _, _, g in boxes] == (
        [16] if (h, w) == (100, 130) else [16, 40])
    _check_box_groups(device, plan, h, w, op, boxes, b)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("b", [4, 32])
def test_box_kernel_on_the_curvelet_group(device, b, op):
    """Kernel B on the curvelet plan's one box group at 512²: 9 bands of a
    72-side box, at batch 4 and at the main path's 32."""
    plan = cv.curvelet_plan(512, 512)
    _, _, boxes = sh._plan_kernel_pack(plan, 512, 512)
    assert [(lg, len(g.idx_h)) for _, lg, g in boxes] == [(9, 72)]
    _check_box_groups(device, plan, 512, 512, op, boxes, b)


@pytest.mark.cuda
def test_box_kernel_needs_the_indices_on_the_card(device):
    """On a CUDA tensor the box update launches its kernel from the box's
    int32 indices, and raises without them."""
    plan = sh.shearlet_plan(128, 128)
    _, lg, g = sh._plan_kernel_pack(plan, 128, 128)[2][0]
    xbox = Cplx(torch.zeros(2, 16, 16, device=device),
                torch.zeros(2, 16, 16, device=device))
    tau = torch.ones(2, lg, device=device)
    with pytest.raises(ValueError, match="index"):
        ksb.box_group_update(xbox, g.psi_on(device), tau, None, 128, 128)
    ih, iw = g.box_index_on(128, 128, device)
    with pytest.raises(ValueError, match="int32"):
        ksb.box_group_update(xbox, g.psi_on(device), tau, None, 128, 128,
                             index=(ih.long(), iw))


def _mags_on(spec: Cplx, psi: torch.Tensor) -> np.ndarray:
    """|ifft2(X·ψ_l)| in float64 on the card, (B, L, H·W), for gap_taus."""
    xf = torch.complex(spec.re, spec.im).to(torch.complex128)
    out = []
    for b in range(xf.shape[0]):
        c = torch.fft.ifft2(xf[b, None] * psi.double())
        out.append(c.abs().reshape(psi.shape[0], -1).cpu().numpy())
    return np.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("b,h,w,chunk", [
    (8, 512, 512, None), (8, 512, 512, 5), (4, 384, 512, None),
    (1, 512, 512, None)],
    ids=["8x512", "8x512-chunks-of-5", "4x384x512", "1x512"])
def test_spatial_kernel_matches_plain(device, b, h, w, chunk, op,
                                      monkeypatch):
    """Kernel C on the shearlet plan's full-size bands (48 at 512²), spatial
    in and out, within 1e-4 of max; the hard threshold on taus away from
    every coefficient. ``chunk`` cuts the scratch to that many bands, so
    the 48 bands run in ten chunks and only the last one inverts; the
    384×512 rectangle takes the direct-DFT line path along H."""
    if chunk is not None:
        monkeypatch.setattr(ksb, "SCRATCH_BYTES", chunk * b * h * w * 8)
        assert ksb.band_chunk(b, h, w, 48) == chunk
    plan = sh.shearlet_plan(h, w)
    full, full_idx, _ = sh._plan_kernel_pack(plan, h, w)
    x, spec = _slices(b, h, w, device, 7)
    psi = full.psi_on(device)
    tau = _taus(x, plan)[:, torch.from_numpy(full_idx).to(device)]
    if op == "hard":
        tau = torch.from_numpy(gap_taus(_mags_on(spec, psi))).to(device)
    tau = tau.contiguous()
    before = ksb.subband_update_spatial.launches
    got = ksb.subband_update_spatial(x, psi, tau, op,
                                     support=full.support_on(device))
    want = ksb.subband_update_spatial_plain(x, psi, tau, op)
    torch.cuda.synchronize()
    assert ksb.subband_update_spatial.launches == before + 1
    got, want = _host(got), _host(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("basis,n", [("shearlet", 256), ("curvelet", 512)])
@pytest.mark.parametrize("spatial", [False, True], ids=["spectral",
                                                        "spatial"])
def test_subband_apply_routes_match_streamed(device, basis, n, spatial,
                                             monkeypatch):
    """Both kernel routes of the fused apply on both spectral-stack plans
    against the plain streamed route (soft thresholds), with their launch
    counts: one subband update and one box update per box group."""
    plan = (sh.shearlet_plan if basis == "shearlet" else cv.curvelet_plan)(
        n, n)
    n_boxes = len(sh._plan_kernel_pack(plan, n, n)[2])
    z, _ = _slices(2, n, n, device, 6)
    tau = _taus(z, plan)
    a = (ksb.subband_update.launches, ksb.subband_update_spatial.launches,
         ksb.box_group_update.launches)
    if spatial:
        monkeypatch.setenv("P3D_SPATIAL_IO", "1")
    else:
        monkeypatch.delenv("P3D_SPATIAL_IO", raising=False)
    got = sh.pocs_subband_apply(z, plan, tau, "soft")
    want = sh._pocs_subband_apply_streamed(z, plan, tau, "soft")
    torch.cuda.synchronize()
    assert (ksb.subband_update.launches - a[0],
            ksb.subband_update_spatial.launches - a[1],
            ksb.box_group_update.launches - a[2]) == (
        int(not spatial), int(spatial), n_boxes)
    got, want = _host(got), _host(want)
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
def test_spatial_route_matches_spectral_on_shearlet(device, monkeypatch):
    """The two kernel routes on the thresholds of iteration 10 of the
    production decay (hard), compared by the SNR against the truth of one
    whole POCS iterate, as chip_smoke.py phase 3b compares: they differ by
    rounding and threshold-boundary flips only."""
    from pseudo_3d_interpolation_torch.models.transforms import (
        ShearletTransform)

    truth, z, mask, _ = _inputs(4, 512, 512, 2, device)
    plan = sh.shearlet_plan(512, 512)
    tau = ShearletTransform(precision="high").decay_from_input(
        z, "exponential", 50, 0.99, "adaptive", "values")[10]
    snrs = []
    monkeypatch.delenv("P3D_SPATIAL_IO", raising=False)
    for spatial in (False, True):
        if spatial:
            monkeypatch.setenv("P3D_SPATIAL_IO", "1")
        rec = sh.pocs_subband_apply(z, plan, tau, "hard", "high")
        x = Cplx(rec.re * (1 - 0.75 * mask) + 0.75 * z.re,
                 rec.im * (1 - 0.75 * mask) + 0.75 * z.im)
        snrs.append(_snr(truth, _host(x)))
    assert abs(snrs[0] - snrs[1]) < SNR_TOL_DB, snrs
    assert snrs[1] > _snr(truth, _host(z))


@pytest.mark.cuda
def test_subband_apply_kernel_route_matches_streamed(device):
    """The kernel route of the fused apply against the plain streamed
    route on the same slices (soft thresholds)."""
    n = 256
    plan = sh.shearlet_plan(n, n)
    z, _ = _slices(2, n, n, device, 6)
    tau = _taus(z, plan)
    a = ksb.subband_update.launches, ksb.box_group_update.launches
    got = sh.pocs_subband_apply(z, plan, tau, "soft")
    want = sh._pocs_subband_apply_streamed(z, plan, tau, "soft")
    torch.cuda.synchronize()
    assert (ksb.subband_update.launches - a[0],
            ksb.box_group_update.launches - a[1]) == (1, 2)
    got, want = _host(got), _host(want)
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
def test_subband_kernels_take_empty_batches(device):
    n = 128
    plan = sh.shearlet_plan(n, n)
    full, _, boxes = sh._plan_kernel_pack(plan, n, n)
    empty = Cplx(torch.empty(0, n, n, device=device),
                 torch.empty(0, n, n, device=device))
    sup = full.support_on(device)
    out = ksb.subband_update(empty, full.psi_on(device),
                             torch.empty(0, full.psi.shape[0], device=device),
                             support=sup)
    assert out.re.shape == (0, n, n)
    out = ksb.subband_update_spatial(
        empty, full.psi_on(device),
        torch.empty(0, full.psi.shape[0], device=device), support=sup)
    assert out.re.shape == (0, n, n)
    _, lg, g = boxes[0]
    sr = len(g.idx_h)
    out = ksb.box_group_update(
        Cplx(torch.empty(0, sr, sr, device=device),
             torch.empty(0, sr, sr, device=device)), g.psi_on(device),
        torch.empty(0, lg, device=device), None, n, n,
        index=g.box_index_on(n, n, device))
    assert out.re.shape == (0, sr, sr)


@pytest.mark.cuda
def test_shearlet_cube_drivers_agree_on_the_card(device):
    """On a SHEARLET cube the host-chunked driver gives the resident
    driver's result bit for bit, through one subband and two box launches
    per batch and iteration."""
    from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
    from pseudo_3d_interpolation_torch.models.transforms import (
        ShearletTransform)
    from pseudo_3d_interpolation_torch.parallel import solver

    truth, _, mask, _ = _inputs(5, 256, 256, 4, device)
    m = mask.cpu().numpy()
    view = np.moveaxis(np.ascontiguousarray(np.moveaxis(truth * m, 0, -1)),
                       -1, 0)
    cfg = POCSConfig(niter=4, p_min="adaptive", version="fast", alpha=0.75,
                     transform_kind="SHEARLET")
    tr = ShearletTransform(precision="high")
    a = ksb.subband_update.launches, ksb.box_group_update.launches
    res = solver.interpolate_cube_resident(view, m, cfg, tr, batch=2,
                                           device=device)
    chunked = solver.interpolate_cube(view, m, cfg, tr, batch=2,
                                      device=device)
    assert (ksb.subband_update.launches - a[0],
            ksb.box_group_update.launches - a[1]) == (2 * 3 * 4, 4 * 3 * 4)
    for x, y in zip(res, chunked):
        np.testing.assert_array_equal(x, y)
    assert _snr(truth, res[0]) > _snr(truth, view)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,spatial", [("CURVELET", False),
                                          ("CURVELET", True),
                                          ("SHEARLET", True)])
def test_spectral_stack_routes_on_the_card_match_the_host(device, kind,
                                                          spatial,
                                                          monkeypatch):
    """``pocs_interpolate`` on CURVELET's route and on the spatial route
    (``P3D_SPATIAL_IO`` set), on the card through the kernels and on the
    host through the plain streamed route (soft thresholds): per
    iteration one subband update (spectral or spatial) and one box update
    per box group."""
    from pseudo_3d_interpolation_torch.models.pocs import (POCSConfig,
                                                           pocs_interpolate)
    from pseudo_3d_interpolation_torch.models.transforms import get_transform

    if spatial:
        monkeypatch.setenv("P3D_SPATIAL_IO", "1")
    else:
        monkeypatch.delenv("P3D_SPATIAL_IO", raising=False)
    truth, z, mask, _ = _inputs(3, 256, 256, 4, device)
    cfg = POCSConfig(niter=4, thresh_op="soft", p_min=1e-3, version="fast",
                     alpha=0.75, transform_kind=kind)
    tr = get_transform(kind)
    n_boxes = len(sh._plan_kernel_pack(tr._plan(256, 256), 256, 256)[2])
    a = (ksb.subband_update.launches, ksb.subband_update_spatial.launches,
         ksb.box_group_update.launches)
    res = pocs_interpolate(z, mask, tr, cfg)
    torch.cuda.synchronize()
    assert (ksb.subband_update.launches - a[0],
            ksb.subband_update_spatial.launches - a[1],
            ksb.box_group_update.launches - a[2]) == (
        4 * int(not spatial), 4 * int(spatial), 4 * n_boxes)
    host = pocs_interpolate(Cplx(z.re.cpu(), z.im.cpu()), mask.cpu(), tr,
                            cfg)
    got, want = _host(res.data), _host(host.data)
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                               4096, 384, 97])
@pytest.mark.parametrize("inverse", [False, True],
                         ids=["forward", "inverse"])
def test_line_engine_matches_torch_fft(device, n, inverse):
    """The subband kernels' line engine (csrc/fft_lines.cuh) alone, at
    every length the plans use: the register FFT for powers of two, the
    direct DFT for 384 and an odd length; within 1e-4 of max."""
    rng = np.random.default_rng(n)
    x = Cplx(*(torch.from_numpy(rng.normal(size=(5, n)).astype(
        np.float32)).to(device) for _ in range(2)))
    got = _host(ksb.line_fft(x, inverse))
    torch.cuda.synchronize()
    want = _host(ksb.line_fft_plain(x, inverse))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


def _edge_windows(h, w, seed):
    """(5, h, w) windows with the support cases the row skip meets: an
    all-zero band, a band with every row, two single-row bands (one row of
    one nonzero, one whole row) and a band on a random half of the rows."""
    rng = np.random.default_rng(seed)
    psi = rng.uniform(0.1, 1.0, size=(5, h, w)).astype(np.float32)
    psi[0] = 0.0
    psi[2] = 0.0
    psi[2, h // 3, w // 2] = 0.8
    psi[3, :h - 1] = 0.0
    psi[4, rng.uniform(size=h) < 0.5] = 0.0
    return psi


@pytest.mark.cuda
@pytest.mark.parametrize("spatial", [False, True],
                         ids=["spectral", "spatial"])
@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("b,h,w,chunk", [(3, 128, 128, None),
                                         (2, 96, 80, None),
                                         (4, 64, 64, 1)],
                         ids=["128", "96x80", "64-chunks-of-1"])
def test_subband_kernels_on_edge_supports(device, b, h, w, chunk, op,
                                          spatial, monkeypatch):
    """Both subband kernels against plain on windows with an all-zero
    band, a band with every row and single-row bands, within 1e-4 of max
    (hard on ``gap_taus``); ``chunk`` cuts the scratch to one band's rows,
    so the bands run in several chunks of the compact scratch."""
    if chunk is not None:
        monkeypatch.setattr(ksb, "SCRATCH_BYTES", chunk * b * h * w * 8)
    psi_np = _edge_windows(h, w, h + w)
    offsets, _ = ksb.row_support(psi_np)
    assert list(np.diff(offsets)[:4]) == [0, h, 1, 1]
    if chunk is not None:
        assert len(ksb.band_chunks(offsets, b, h, w)) - 1 > 1
    psi = torch.from_numpy(psi_np).to(device)
    x, spec = _slices(b, h, w, device, 8)
    if op == "hard":
        tau = torch.from_numpy(gap_taus(_mags_on(spec, psi))).to(device)
    else:
        amax = _mags_on(spec, psi).max(axis=-1)
        tau = torch.from_numpy((0.3 * amax).astype(np.float32)).to(device)
    tau = tau.contiguous()
    kernel, plain, arg = (
        (ksb.subband_update_spatial, ksb.subband_update_spatial_plain, x)
        if spatial else (ksb.subband_update, ksb.subband_update_plain, spec))
    support = ksb.row_support_on(psi_np, device)
    got = _host(kernel(arg, psi, tau, op, "high", support=support))
    want = _host(plain(arg, psi, tau, op))
    torch.cuda.synchronize()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("spatial", [False, True],
                         ids=["spectral", "spatial"])
@pytest.mark.parametrize("op", ["soft", "garrote"])
def test_subband_kernels_at_batch_32_in_chunks(device, op, spatial):
    """The main path's batch: 32 slices of 512², the shearlet plan's 48
    full-size bands in more than one chunk of the compact scratch, against
    plain within 1e-4 of max."""
    plan = sh.shearlet_plan(512, 512)
    full, full_idx, _ = sh._plan_kernel_pack(plan, 512, 512)
    support = full.support_on(device)
    assert len(ksb.band_chunks(support.offsets, 32, 512, 512)) - 1 > 1
    x, spec = _slices(32, 512, 512, device, 9)
    psi = full.psi_on(device)
    tau = _taus(x, plan)[:, torch.from_numpy(full_idx).to(device)]
    tau = tau.contiguous()
    kernel, plain, arg = (
        (ksb.subband_update_spatial, ksb.subband_update_spatial_plain, x)
        if spatial else (ksb.subband_update, ksb.subband_update_plain, spec))
    got = kernel(arg, psi, tau, op, "high", support=support)
    want = plain(arg, psi, tau, op)
    got = torch.complex(got.re, got.im)
    want = torch.complex(want.re, want.im)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= SOFT_TOL * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 1 << 20])
@pytest.mark.parametrize("method", ["average", "idw", "nearest", "median"])
def test_stack_functions_on_the_card_match_the_cpu(device, method, budget):
    """The binning stacks (plain PyTorch ops, no kernel) on the card
    against the same call on the host: bins with folds 0-7 in shuffled
    order and tied distances; nearest and median exact, average and IDW
    (atomic sums in another order) within 1e-6 of max; the median also in
    chunks of 1 MB."""
    from pseudo_3d_interpolation_torch.ops import binning as bn

    rng = np.random.default_rng(12)
    n_bins, ns = 4096, 256
    ids = np.repeat(np.arange(n_bins), rng.integers(0, 8, n_bins))
    ids = ids[rng.permutation(len(ids))]
    traces = rng.standard_normal((len(ids), ns)).astype(np.float32)
    dist = rng.integers(0, 4, len(ids)) * 2.5
    want = bn.stack_traces(traces, ids, n_bins, method=method, dist=dist,
                           device="cpu")
    if method == "median":
        got = bn.stack_median(traces, ids, n_bins, 7, device=device,
                              budget=budget)
    else:
        got = bn.stack_traces(traces, ids, n_bins, method=method, dist=dist,
                              device=device)
    assert got.device.type == "cuda"
    got = got.cpu()
    if method in ("nearest", "median"):
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    assert torch.equal(bn.fold_map(ids, n_bins, device=device).cpu(),
                       bn.fold_map(ids, n_bins, device="cpu"))


# --- the percentile route: the split passes and the selection kernel --


def _percentile_case(kind, b, h, w, device, seed=5):
    """The spectrum of plane waves under a column mask, the plan's kernel
    packing and per-(slice, band) percentiles in [60, 99.9]."""
    truth, z, mask, _ = _inputs(b, h, w, 2, device, seed)
    xf = torch.fft.fft2(torch.complex(z.re, z.im))
    plan = (sh.shearlet_plan(h, w) if kind == "SHEARLET"
            else cv.curvelet_plan(h, w))
    full, full_idx, boxes = sh._plan_kernel_pack(plan, h, w)
    nbands = len(full_idx) + sum(lg for _, lg, _ in boxes)
    q = torch.from_numpy(np.random.default_rng(seed).uniform(
        60.0, 99.9, size=(b, nbands)).astype(np.float32)).to(device)
    return truth, z, mask, xf, full, full_idx, boxes, q


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 3, 64, 64), (2, 5, 97, 130),
                                   (1, 2, 512, 512)])
@pytest.mark.parametrize("keys_of", ["uniform", "ties", "nan"])
def test_band_percentile_bit_equal_to_plain(device, shape, keys_of):
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp

    gen = torch.Generator(device="cpu").manual_seed(sum(shape))
    keys = torch.rand(shape, generator=gen)
    if keys_of == "ties":
        keys = torch.round(keys * 6)
    if keys_of == "nan":
        keys[0, 1, 2, 3] = float("nan")
    keys = keys.to(device)
    s, c = shape[:2]
    q = torch.tensor([0.0, 37.5, 99.9, 100.0, 60.0, 150.0, -1.0] * (s * c),
                     dtype=torch.float32)[:s * c].reshape(s, c).to(device)
    got = kp.band_percentile(keys, q, kp.key_histogram_plain(keys))
    want = kp.band_percentile_plain(keys, q)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 64), (512, 512), (97, 130)])
def test_band_percentile_over_capacity(device, hw):
    """Segments whose rank falls in a first-digit bin holding more than the
    candidate buffer (all-equal keys, keys inside one quarter of an
    exponent) are finished over their keys, beside segments that fit and
    a segment whose rank lo is the last key of its bin: all bit-equal to
    the plain version."""
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp

    h, w = hw
    n = h * w
    gen = torch.Generator(device="cpu").manual_seed(n)
    keys = torch.rand((2, 4, h, w), generator=gen)
    keys[0, 0] = 0.37
    keys[0, 1] = 1.0 + 0.25 * keys[0, 1]
    half = n // 2
    split = torch.cat([1.0 + 0.25 * torch.rand(half, generator=gen),
                       4.0 + torch.rand(n - half, generator=gen)])
    keys[1, 0] = split[torch.randperm(n, generator=gen)].reshape(h, w)
    keys = keys.to(device)
    top = float(np.float32(n) - np.float32(1))
    # q that puts rank lo on the last key of the lower half in keys[1, 0]
    q_last = float(np.float32((half - 0.5) / top * 100.0))
    q = torch.tensor([[0.0, 60.0, 99.9, 37.5], [q_last, 60.0, 100.0, 50.0]],
                     dtype=torch.float32, device=device)
    hist = kp.key_histogram_plain(keys)
    cap = kp.candidate_capacity(n)
    first = torch.argmax(hist[..., :kp.KEY_BINS], dim=-1)
    assert int(hist[0, 0, first[0, 0]]) > cap
    assert int(hist[0, 1, first[0, 1]]) > cap
    got = kp.band_percentile(keys, q, hist)
    want = kp.band_percentile_plain(keys, q)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,w", [("SHEARLET", 128, 128),
                                      ("SHEARLET", 96, 130),
                                      ("CURVELET", 256, 256)])
def test_pass_1_histogram_matches_plain(device, kind, h, w):
    """The first-digit histogram pass 1 counts as it writes the keys
    (subband_keys, box_keys) equals the plain histogram of the keys it
    returns, NaN column included."""
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp

    b = 3
    _, _, _, xf, full, _, boxes, _ = _percentile_case(kind, b, h, w, device)
    spec = Cplx(xf.real.contiguous(), xf.imag.contiguous())
    psi = full.psi_on(device)
    support = full.support_on(device)
    l1 = int(support.chunks(b, h, w)[0][1])
    keys, hist = ksb.subband_keys(spec, psi, support, 0, l1,
                                  ksb.percentile_work(spec, support))
    torch.cuda.synchronize()
    assert keys.shape == (b, l1, h, w)
    assert torch.equal(hist, kp.key_histogram_plain(keys))
    for l0, lg, g in boxes:
        ih, iw = g.index_on(device)
        box = xf[:, ih[:, None], iw[None, :]]
        xb = Cplx(box.real.contiguous(), box.imag.contiguous())
        work = torch.empty(ksb.box_work_floats(b, lg, len(iw), h),
                           device=device)
        keys, hist = ksb.box_keys(xb, g.psi_on(device), None, h, w,
                                  index=g.box_index_on(h, w, device),
                                  work=work)
        torch.cuda.synchronize()
        assert torch.equal(hist, kp.key_histogram_plain(keys))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [3000, 1536])
@pytest.mark.parametrize("op", ["soft", "garrote"])
def test_split_update_on_tall_slices(device, h, op):
    """Sides whose column tile leaves less than the block's histogram free
    in shared memory when sized without it (3000 and 1536 rows): pass 1
    sizes its own tile with the histogram counted, so its histogram equals
    the plain one of its keys and the split update matches its plain
    version within SOFT_TOL·max."""
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp

    b, w = 2, 64
    psi_np = _edge_windows(h, w, h + w)
    psi = torch.from_numpy(psi_np).to(device)
    support = ksb.row_support_on(psi_np, device)
    _, spec = _slices(b, h, w, device, 9)
    q = torch.from_numpy(np.random.default_rng(h).uniform(
        60.0, 99.9, size=(b, psi.shape[0])).astype(np.float32)).to(device)
    l1 = int(support.chunks(b, h, w)[0][1])
    keys, hist = ksb.subband_keys(spec, psi, support, 0, l1,
                                  ksb.percentile_work(spec, support))
    torch.cuda.synchronize()
    assert torch.equal(hist, kp.key_histogram_plain(keys))
    got = _host(ksb.subband_update_percentile(
        spec, psi, q, f"{op}-percentile", support=support))
    want = _host(ksb.subband_update_percentile_plain(spec, psi, q, op))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,w", [("SHEARLET", 128, 128),
                                      ("SHEARLET", 256, 256),
                                      ("CURVELET", 256, 256),
                                      ("SHEARLET", 96, 130)])
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
def test_split_passes_match_plain(device, kind, h, w, op):
    """Pass 1's keys, the selection on them, and the whole split update of
    the full-size bands and each box group against their plain versions:
    keys within 1e-5·max, soft and garrote within SOFT_TOL·max, hard by
    the SNR against the truth of the POCS iterate each side's updates make
    (a coefficient at the threshold flips under reordered arithmetic, and
    a box group's flip moves its whole box), as chip_smoke.py's phase 17a
    holds them."""
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp

    b = 3
    truth, z, mask, xf, full, full_idx, boxes, q = _percentile_case(
        kind, b, h, w, device)
    spec = Cplx(xf.real.contiguous(), xf.imag.contiguous())
    psi = full.psi_on(device)
    support = full.support_on(device)
    qf = q[:, torch.from_numpy(full_idx).to(device)].contiguous()
    work = ksb.percentile_work(spec, support)
    l1 = int(support.chunks(b, h, w)[0][1])
    keys, hist = ksb.subband_keys(spec, psi, support, 0, l1, work)
    plain = ksb.subband_keys_plain(spec, psi[:l1])
    assert (keys - plain).abs().max() <= 1e-5 * plain.max()
    t = kp.band_percentile(keys, qf[:, :l1].contiguous(), hist)
    assert torch.equal(t.view(torch.int32), kp.band_percentile_plain(
        keys, qf[:, :l1].contiguous()).view(torch.int32))
    pairs = [(ksb.subband_update_percentile(
        spec, psi, qf, f"{op}-percentile", support=support),
              ksb.subband_update_percentile_plain(spec, psi, qf, op))]
    sels = [(slice(None),) * 3]
    for l0, lg, g in boxes:
        ih, iw = g.index_on(device)
        sels.append((slice(None), ih[:, None], iw[None, :]))
        box = xf[:, ih[:, None], iw[None, :]]
        xb = Cplx(box.real.contiguous(), box.imag.contiguous())
        qb = q[:, l0:l0 + lg].contiguous()
        mats = g.box_mats_on(h, w, device)
        pairs.append((ksb.box_group_update_percentile(
            xb, g.psi_on(device), qb, mats, h, w, op,
            index=g.box_index_on(h, w, device)),
                      ksb.box_group_update_percentile_plain(
            xb, g.psi_on(device), qb, mats, h, w, op)))
    torch.cuda.synchronize()
    if op == "hard":
        obs = torch.complex(z.re, z.im)
        snrs = []
        for side in (0, 1):
            acc = torch.zeros_like(xf)
            for sel, pair in zip(sels, pairs):
                acc[sel] += torch.complex(pair[side].re, pair[side].im)
            x = torch.fft.ifft2(acc) * (1 - 0.75 * mask) + 0.75 * obs
            snrs.append(_snr(truth, x.cpu().numpy()))
        assert abs(snrs[0] - snrs[1]) <= SNR_TOL_DB
        return
    for got, want in pairs:
        got, want = _host(got), _host(want)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,w,k,line", [
    ("SHEARLET", 512, 512, 0, 16), ("SHEARLET", 512, 512, 1, 64),
    ("CURVELET", 512, 512, 0, 128), ("SHEARLET", 256, 256, 1, 64),
    ("CURVELET", 384, 384, 0, 64)])
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
def test_pruned_box_passes_match_plain_and_general(device, kind, h, w, k,
                                                   line, op):
    """box_keys and box_shrink on the standard groups, in the pruned form
    their indices plan (at 384 a row of 24 threads, which syncs the block)
    and in the general form: each form's keys within SOFT_TOL·max of the
    plain keys and the two forms' within 1e-5·max of each other, its
    histogram the plain one of its keys, the selection on them bit-equal,
    and box_shrink at those thresholds (hard: thresholds in a gap of the
    keys, which no rounding crosses) against box_group_update_plain within
    SOFT_TOL·max."""
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp

    b = 4
    _, _, _, xf, _, _, boxes, q = _percentile_case(kind, b, h, w, device)
    l0, lg, g = boxes[k]
    index = g.box_index_on(h, w, device)
    assert index.line is not None and index.line[1] == line
    ih, iw = g.index_on(device)
    box = xf[:, ih[:, None], iw[None, :]]
    xb = Cplx(box.real.contiguous(), box.imag.contiguous())
    psi, mats = g.psi_on(device), g.box_mats_on(h, w, device)
    qb = q[:, l0:l0 + lg].contiguous()
    plain_keys = ksb.box_keys_plain(xb, psi, mats, h, w)
    keys_of = {}
    for form, idx in (("pruned", index),
                      ("general", ksb.BoxIndex(index[0], index[1], None))):
        work = torch.empty(ksb.box_work_floats(b, lg, len(g.idx_w), h),
                           device=device)
        launches = ksb.box_keys.launches, ksb.box_shrink.launches
        keys, hist = ksb.box_keys(xb, psi, None, h, w, index=idx, work=work)
        torch.cuda.synchronize()
        assert (keys - plain_keys).abs().max() <= SOFT_TOL * plain_keys.max()
        assert torch.equal(hist, kp.key_histogram_plain(keys))
        t = kp.band_percentile(keys, qb, hist)
        assert torch.equal(t.view(torch.int32), kp.band_percentile_plain(
            keys, qb).view(torch.int32))
        if op == "hard":
            t = torch.from_numpy(gap_taus(
                keys.reshape(b, lg, -1).cpu().numpy())).to(device)
        got = _host(ksb.box_shrink(xb, psi, t, None, h, w, op, index=idx,
                                   work=work))
        assert (ksb.box_keys.launches, ksb.box_shrink.launches) == (
            launches[0] + 1, launches[1] + 1)
        want = _host(ksb.box_group_update_plain(xb, psi, t, mats, h, w, op))
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()
        keys_of[form] = keys
    assert (keys_of["pruned"] - keys_of["general"]).abs().max() <= \
        1e-5 * plain_keys.max()


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,o,line", [
    (512, 20, 500, 32), (1024, 200, 900, 256), (384, 40, 370, 64),
    (128, 9, 0, 16)])
@pytest.mark.parametrize("op", ["soft", "hard"])
def test_pruned_box_passes_on_wrapped_ranges(device, n, s, o, line, op):
    """The pruned row pass at the line lengths the plans do not reach
    (s' = 32 and 256: two and sixteen threads a class) and on a 384 side
    (24 threads a row, which sync the block), on boxes of s rows and the
    wrapped column range o.. (mod n), random windows and spectra: box_keys
    and box_shrink against their plain versions within SOFT_TOL·max, hard
    thresholds in a gap of the keys."""
    from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp

    b, lg = 3, 2
    rng = np.random.default_rng(n + s)
    idx_w = ((o + np.arange(s)) % n).astype(np.int32)
    rng.shuffle(idx_w)
    g = sh._ScaleGroup(np.arange(s, dtype=np.int32), idx_w,
                       rng.uniform(0, 1, size=(lg, s, s)).astype(np.float32))
    index = g.box_index_on(n, n, device)
    assert index.line == (o, line)
    xb = Cplx(*(torch.from_numpy(rng.normal(size=(b, s, s)).astype(
        np.float32)).to(device) for _ in range(2)))
    psi, mats = g.psi_on(device), g.box_mats_on(n, n, device)
    work = torch.empty(ksb.box_work_floats(b, lg, s, n), device=device)
    keys, hist = ksb.box_keys(xb, psi, None, n, n, index=index, work=work)
    plain_keys = ksb.box_keys_plain(xb, psi, mats, n, n)
    torch.cuda.synchronize()
    assert (keys - plain_keys).abs().max() <= SOFT_TOL * plain_keys.max()
    assert torch.equal(hist, kp.key_histogram_plain(keys))
    t = (torch.from_numpy(gap_taus(keys.reshape(b, lg, -1).cpu().numpy()))
         if op == "hard" else 0.3 * keys.reshape(b, lg, -1).mean(-1).cpu())
    t = t.to(device).contiguous()
    got = _host(ksb.box_shrink(xb, psi, t, None, n, n, op, index=index,
                               work=work))
    want = _host(ksb.box_group_update_plain(xb, psi, t, mats, n, n, op))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["SHEARLET", "CURVELET"])
def test_percentile_solve_on_the_card_matches_the_host(device, kind):
    """The directional solve with a percentile threshold through the split
    kernels against the plain streamed route on the host, by SNR."""
    from pseudo_3d_interpolation_torch.models.pocs import (POCSConfig,
                                                           pocs_interpolate)

    truth, z, mask, _ = _inputs(2, 128, 128, 2, device)
    cfg = POCSConfig(niter=15, thresh_op="hard-percentile",
                     decay_kind="factors", p_max=99.9, p_min=60.0,
                     version="fast", alpha=0.75, transform_kind=kind)
    ksb.subband_keys.launches = 0
    card = pocs_interpolate(z, mask, config=cfg)
    assert ksb.subband_keys.launches == 15
    host = pocs_interpolate(Cplx(z.re.cpu(), z.im.cpu()), mask.cpu(),
                            config=cfg)
    assert abs(_snr(truth, _host(card.data))
               - _snr(truth, _host(host.data))) <= SNR_TOL_DB


# --- the split plans on the box kernel, and the native SEG-Y decoder ------

def _split_boxes(h, w, split):
    """The box groups of the h × w SHEARLET split plan that are not
    centred square boxes (the fine scale's narrow shears: exact,
    non-contiguous index lists)."""
    plan = sh.shearlet_plan(h, w, split_threshold=split)
    boxes = [(l0, lg, g) for l0, lg, g in sh._plan_kernel_pack(plan, h, w)[2]
             if len(g.idx_h) != len(g.idx_w)]
    assert boxes, f"the {h}x{w} plan split at {split} has no narrow box"
    return plan, boxes


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("h,w,b,split", [(128, 128, 4, 60),
                                         (512, 512, 4, 200),
                                         (512, 512, 32, 200)])
def test_box_kernel_on_split_plan_groups(device, h, w, b, split, op):
    """Kernel B on the split plan's sr × sc groups (at 512²: 447 × 126,
    126 × 447, 447 × 63 and 63 × 447), against plain within 1e-4 of max;
    the hard threshold on taus away from every coefficient."""
    plan, boxes = _split_boxes(h, w, split)
    _check_box_groups(device, plan, h, w, op, boxes, b)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["soft", "hard-percentile"])
def test_split_plan_apply_on_the_card_matches_the_host(device, op,
                                                       monkeypatch):
    """``pocs_subband_apply`` on the 256² SHEARLET split plan: on the card
    one subband update (or its split passes) and one box launch per box
    group, and no plain version; against the host's plain streamed route
    within 1e-4 of max (soft) or 3e-3 (a hard percentile lands on a
    coefficient and may flip it)."""
    h = w = 256
    plan = sh.shearlet_plan(h, w, split_threshold=100)
    _, _, boxes = sh._plan_kernel_pack(plan, h, w)
    x, _ = _slices(3, h, w, device, 6)
    if op == "soft":
        tau = _taus(x, plan)
    else:
        tau = torch.full((3, len(plan.perm)), 90.0, device=device)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's route")
    for name in ("subband_update_plain", "box_group_update_plain",
                 "subband_keys_plain", "subband_shrink_plain",
                 "box_keys_plain"):
        monkeypatch.setattr(ksb, name, refuse)
    boxes_of = ("box_keys" if op.endswith("percentile")
                else "box_group_update")
    before = getattr(ksb, boxes_of).launches
    got = sh.pocs_subband_apply(x, plan, tau, op)
    torch.cuda.synchronize()
    assert getattr(ksb, boxes_of).launches - before == len(boxes)
    monkeypatch.undo()
    want = sh.pocs_subband_apply(Cplx(x.re.cpu(), x.im.cpu()), plan,
                                 tau.cpu(), op)
    got, want = _host(got), _host(want)
    tol = SOFT_TOL if op == "soft" else 3e-3
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [1, 2, 3, 5, 8])
def test_native_decoder_on_the_card_machine(device, tmp_path, fmt):
    """The card's machine builds the native decoder (g++) and decodes every
    format bit for bit as the numpy path does."""
    from pseudo_3d_interpolation_torch import backends
    from pseudo_3d_interpolation_torch.io import segy

    assert backends.native_segy_enabled(), backends.native_segy_error()
    rng = np.random.default_rng(fmt)
    data = rng.normal(size=(300, 700)) * {1: 1e3, 2: 1e6, 3: 1e3, 5: 1e3,
                                          8: 30}[fmt]
    if fmt in (2, 3, 8):
        data = np.clip(np.round(data), -120 if fmt == 8 else -3e4,
                       120 if fmt == 8 else 3e4)
    path = str(tmp_path / f"f{fmt}.sgy")
    segy.write_segy(path, data.astype(np.float32), fmt=fmt, dt_us=100)
    with segy.SegyFile(path) as f:
        got = f.trace_data()
        want = segy._decode_samples(np.asarray(f._traces_u8[:, 240:]), fmt)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
