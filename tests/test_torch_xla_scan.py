"""The plain scan route (``xla-scan``) of the port against the JAX
package's: ``models.pocs.pocs_interpolate`` on the DCT basis (any slice
shape), the WAVELET basis (square, padded and non-square slices) and the
FFT, DCT and WAVELET bases with a per-slice mask or a (2, 3, H, W) batch,
each under regular, fast and adaptive, with eps 1e-2 (lane freezing) and
the cost history, and with eps 1e-2 and ``global_early_stop``. Then the
routes of JAX tests/test_solver_route.py's table, ``pocs_interpolate_numpy``
and ``pipeline.pocs.interpolate`` on a small cube with DCT at eps 1e-16.
The JAX side runs its own ``xla-scan``, which reaches no Pallas kernel.

Tolerances: soft and garrote thresholds move the result by float32
rounding only, max|Δ| ≤ 1e-4·max|JAX|, and the cost history within 1e-3
relative. Hard thresholds flip coefficients at the threshold under
reordered arithmetic: SNR against the truth within 0.1 dB. The effective
iteration counts are equal on every slice whose JAX cost history keeps 1%
away from eps at every iteration that can stop it (the test checks that
margin from the JAX history); closer than that, rounding may stop one
side an iteration earlier."""

import dataclasses
import importlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe
from test_solver_route import CLI_DEFAULT, ROUTING_TABLE

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

SOFT_TOL = 1e-4
COST_RTOL = 1e-3
SNR_TOL_DB = 0.1
EPS = 1e-2
EPS_MARGIN = 0.01  # iteration counts compared where |cost − eps| > 1% eps
NITER = 10
BASE = dict(niter=NITER, thresh_model="exponential", p_max=0.99,
            p_min=1e-3, alpha=0.75, eps=EPS, use_pallas=True,
            pallas_interpret=True)
OPS = ("soft", "hard", "garrote")
VERSIONS = ("regular", "fast", "adaptive")

# (basis, slice-batch shape, mask: "2d" the shared (H, W) mask, "slice" one
# mask per slice) — each takes the JAX package's xla-scan route
CASES = [
    ("DCT", (3, 64, 64), "2d"),
    ("DCT", (3, 96, 128), "2d"),
    ("DCT", (3, 100, 100), "2d"),
    ("WAVELET", (3, 64, 64), "2d"),
    ("WAVELET", (3, 100, 100), "2d"),  # padded to 104x104
    ("WAVELET", (3, 96, 128), "2d"),  # non-square
    ("FFT", (3, 64, 64), "slice"),
    ("FFT", (2, 3, 64, 64), "2d"),
    ("DCT", (3, 96, 128), "slice"),
    ("WAVELET", (2, 3, 64, 64), "2d"),
]


def _truth(shape, mask_kind, seed):
    """Plane waves on every slice of ``shape`` (..., H, W) and a 50%
    column mask, shared or one per slice."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros(shape, np.complex64)
    for idx in np.ndindex(*shape[:-2]):
        for _ in range(3):
            fy, fx = rng.integers(1, 8, size=2)
            truth[idx] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 6.28))
    if mask_kind == "2d":
        cols = (rng.uniform(size=w) < 0.5).astype(np.float32)
        mask = np.ascontiguousarray(np.broadcast_to(cols, (h, w)))
    else:
        cols = (rng.uniform(size=shape[:-2] + (1, w)) < 0.5)
        mask = np.ascontiguousarray(np.broadcast_to(cols, shape), np.float32)
    return truth, mask


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


def _np(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def _pair(a):
    return Cplx(torch.from_numpy(np.ascontiguousarray(a.real, np.float32)),
                torch.from_numpy(np.ascontiguousarray(a.imag, np.float32)))


def _jpair(a):
    return JCplx(jnp.asarray(a.real, jnp.float32),
                 jnp.asarray(a.imag, jnp.float32))


def _solve_both(obs, mask, kind, **change):
    jcfg = jpocs.POCSConfig(**dict(BASE, transform_kind=kind, **change))
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jres = jpocs.pocs_interpolate(_jpair(obs), jnp.asarray(mask), jget(kind),
                                  jcfg)
    res = pocs.pocs_interpolate(_pair(obs), torch.from_numpy(mask),
                                get_transform(kind), cfg)
    return jres, res, cfg


def _agree(got, want, op, truth):
    if op == "hard":
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        d = np.abs(got - want).max()
        assert d <= SOFT_TOL * np.abs(want).max(), d / np.abs(want).max()


def _clear_of_eps(history, n_iter):
    """Per slice: whether the JAX cost history keeps more than 1% of eps
    away from eps at every iteration whose test can stop the slice (from
    the fourth to the one it stopped at)."""
    hist = np.asarray(history).reshape(history.shape[0], -1)
    n = np.asarray(n_iter).reshape(-1)
    return np.array([np.all(np.abs(hist[3:k, b] - EPS) > EPS_MARGIN * EPS)
                     for b, k in enumerate(n)])


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("kind,shape,mask_kind", CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}-{m}"
                              for k, s, m in CASES])
def test_scan_matches_jax(kind, shape, mask_kind, version):
    case = CASES.index((kind, shape, mask_kind))
    op = OPS[(case + VERSIONS.index(version)) % 3]  # each pair somewhere
    truth, mask = _truth(shape, mask_kind, seed=case)
    obs = truth * mask
    jres, res, cfg = _solve_both(obs, mask, kind, thresh_op=op,
                                 version=version, keep_cost_history=True)
    route = pocs.solver_route(obs.shape, mask.shape, cfg,
                              get_transform(kind))
    assert route.route == "xla-scan" and pocs.runs(route)
    got, want = _np(res.data), _np(jres.data)
    assert got.shape == obs.shape and np.isfinite(got).all()
    _agree(got, want, op, truth)
    assert res.n_iterations.shape == res.cost.shape == shape[:-2]
    assert res.cost_history.shape == (NITER,) + shape[:-2]
    clear = _clear_of_eps(jres.cost_history, jres.n_iterations)
    assert clear.any(), "every slice's cost passes within 1% of eps"
    n_got = res.n_iterations.numpy().reshape(-1)
    n_want = np.asarray(jres.n_iterations).reshape(-1)
    np.testing.assert_array_equal(n_got[clear], n_want[clear])
    assert (n_want < NITER).any(), "eps stopped no slice"
    if op != "hard":
        np.testing.assert_allclose(res.cost_history.numpy(),
                                   np.asarray(jres.cost_history),
                                   rtol=COST_RTOL)
        np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                                   rtol=COST_RTOL)

    # the same with global_early_stop: the loop ends when every slice has
    # stopped, with the lane-freezing scan's result
    jstop, stop, _ = _solve_both(obs, mask, kind, thresh_op=op,
                                 version=version, global_early_stop=True)
    assert stop.cost_history is None and jstop.cost_history is None
    _agree(_np(stop.data), _np(jstop.data), op, truth)
    n_stop = stop.n_iterations.numpy().reshape(-1)
    np.testing.assert_array_equal(
        n_stop[clear], np.asarray(jstop.n_iterations).reshape(-1)[clear])
    np.testing.assert_array_equal(n_stop, n_got)
    np.testing.assert_array_equal(_np(stop.data), got)


# the rows of JAX tests/test_solver_route.py's table whose reason is not a
# TPU-only gate (the %128 tiles, Pallas off)
TPU_ONLY_REASONS = ("not both %128", "use_pallas=False")
PORTED_ROWS = [row for row in ROUTING_TABLE
               if not any(r in row[4] for r in TPU_ONLY_REASONS)]
# the CURVELET percentile row the JAX table lacks, routed as its SHEARLET
# row
PORTED_ROWS.append(({"transform_kind": "CURVELET",
                     "thresh_op": "soft-percentile",
                     "decay_kind": "factors"}, PORTED_ROWS[0][1],
                    "streamed-subband", "", "threshold"))


@pytest.mark.parametrize("over,shape,route,basis,reason_sub", PORTED_ROWS)
def test_routing_table_rows_route_and_run(over, shape, route, basis,
                                          reason_sub):
    """Each row routes as in the JAX package, and every row runs: a
    directional basis with a percentile threshold too, on the split
    subband kernels (plain versions here), its reason the JAX wording."""
    jcfg = dataclasses.replace(CLI_DEFAULT, **over)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    jrt = jpocs.solver_route(shape, shape[-2:], jcfg)
    rt = pocs.solver_route(shape, shape[-2:], cfg)
    assert tuple(rt) == tuple(jrt)
    assert (rt.route, rt.basis) == (route, basis)
    z = Cplx(torch.rand(shape, generator=torch.Generator().manual_seed(0)),
             torch.zeros(shape))
    mask = torch.ones(shape[-2:])
    assert pocs.runs(rt)
    if route == "streamed-subband" and rt.reason:
        assert pocs.describe_route(rt) == f"streamed-subband — {jrt.reason}"
        res = pocs.pocs_interpolate(z, mask, config=dataclasses.replace(
            cfg, niter=2))
        assert res.data.re.shape == shape
        assert bool(torch.isfinite(res.data.re).all())
        return
    if route == "xla-scan":
        assert pocs.describe_route(rt) == f"xla-scan[{basis}] — {jrt.reason}"
    if route in ("xla-scan", "fused-periter"):
        res = pocs.pocs_interpolate(z, mask, config=dataclasses.replace(
            cfg, niter=2))
        assert res.data.re.shape == shape
        assert res.n_iterations.shape == shape[:-2]
        assert bool(torch.isfinite(res.data.re).all())


@pytest.mark.parametrize("is_complex", [False, True])
def test_pocs_interpolate_numpy_matches_jax(is_complex):
    """numpy in and out on both sides; a real input comes back real."""
    truth, mask = _truth((2, 64, 64), "2d", seed=20)
    obs = truth * mask if is_complex else (truth * mask).real.copy()
    jcfg = jpocs.POCSConfig(**dict(BASE, transform_kind="DCT",
                                   thresh_op="soft", use_pallas=False,
                                   pallas_interpret=False))
    want, jn, jc = jpocs.pocs_interpolate_numpy(obs, mask, jcfg)
    got, n, c = pocs.pocs_interpolate_numpy(
        obs, mask, compat.config_from_reference(dataclasses.asdict(jcfg)),
        device="cpu")
    assert got.dtype == (np.complex64 if is_complex else np.float32)
    assert got.shape == obs.shape
    assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_allclose(c, jc, rtol=COST_RTOL)


def test_pocs_interpolate_numpy_needs_a_card_or_cpu():
    """Without a card the default device raises: nothing falls back to
    the host unless the caller asks for ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pocs.pocs_interpolate_numpy(np.ones((1, 8, 8), np.float32),
                                    np.ones((8, 8)), pocs.POCSConfig())


def _cubes(obs, mask):
    coords = {"iline": np.arange(obs.shape[1]),
              "xline": np.arange(obs.shape[2]),
              "freq": np.arange(obs.shape[0], dtype=np.float64)}
    data_vars = {"amp": (("iline", "xline", "freq"),
                         np.ascontiguousarray(np.moveaxis(obs, 0, -1))),
                 "fold": (("iline", "xline"), mask.astype(np.int32))}
    return (JCube(coords=dict(coords), data_vars=dict(data_vars)),
            Cube(coords=dict(coords), data_vars=dict(data_vars)))


def _rec(cube):
    return np.moveaxis(np.asarray(cube.data_vars["amp_interp"][1]), -1, 0)


@pytest.mark.parametrize("op", ["soft", "hard"])
def test_interpolate_dct_at_the_recommended_eps_matches_jax(op, caplog):
    """A 3-slice 128² cube through both packages' ``interpolate`` at the
    reference's recommended configuration on the DCT basis (FPOCS, alpha
    0.75, exponential decay, adaptive p_min, eps 1e-16): route
    ``xla-scan[dct]``, logged with its reason."""
    truth, mask = _truth((3, 128, 128), "2d", seed=21)
    obs = truth * mask
    meta = dict(niter=NITER, thresh_op=op, thresh_model="exponential",
                p_min="adaptive", version="fast", alpha=0.75, eps=1e-16,
                transform_kind="DCT", precision="highest")
    jcube, cube = _cubes(obs, mask)
    jout = jpipe.interpolate(jcube, config={"metadata": meta},
                             mesh=make_mesh(1))
    with caplog.at_level(logging.INFO, logger=pipe.log.name):
        out = pipe.interpolate(cube, config={"metadata": meta}, verbose=1,
                               device="cpu")
    assert ("solver path: xla-scan[dct] — eps=1e-16 != 0.0 (early stopping "
            "needs the scan)") in caplog.text
    got, want = _rec(out), _rec(jout)
    assert got.dtype == np.complex64 and got.shape == obs.shape
    assert _snr(truth, got) > _snr(truth, obs)
    _agree(got, want, op, truth)
    assert out.attrs["history"] == jout.attrs["history"]
    if op == "soft":
        assert out.attrs["pocs_mean_iterations"] == \
            jout.attrs["pocs_mean_iterations"]


def test_scan_budget_matches_the_per_iteration_scan():
    """The driver budgets the plain scan on FFT, DCT and WAVELET as the
    scan over the iteration kernel: expansion 2."""
    cfg = pocs.POCSConfig(eps=1e-16, transform_kind="DCT")
    for kind in ("FFT", "DCT", "WAVELET"):
        tr = get_transform(kind)
        assert pipe._transform_subbands(tr, (512, 512), dataclasses.replace(
            cfg, transform_kind=kind)) == 2
        assert pipe._transform_subbands(tr, (512, 512), dataclasses.replace(
            cfg, transform_kind=kind, eps=0.0)) == 1
    pct = dataclasses.replace(cfg, eps=0.0, thresh_op="hard-percentile",
                              decay_kind="factors", p_max=99.9, p_min=60.0)
    assert pocs.solver_route((32, 512, 512), (512, 512), pct).route == \
        "xla-scan"
    assert pipe._transform_subbands(get_transform("DCT"), (512, 512),
                                    pct) == 2
    assert pipe._transform_device_bytes(get_transform("DCT"), 32, 512,
                                        512) == 0
