"""``pad_to_tile`` and ``utils/pad`` of the port against the JAX package's.

With ``pad_to_tile=True`` both cube drivers solve every slice zero-padded
to 128-multiple sides (an observed-zero frame: amplitude 0, mask 1) and
crop the result, as the JAX drivers do; ``None`` resolves to False off a
TPU in the JAX package and always here (the port's kernels take any
H×W). The slices are 100×120, padded to 128×128.

Tolerances, against ``max|JAX|``: ``TOL`` = 2.5e-6 for the FFT and DCT
bases with a soft threshold, about twenty float32 roundings (2^-23 each)
over the 10 iterations of float32 FFTs against the JAX matmul DFTs
(1.2e-6 to 1.6e-6 measured); ``SHEARLET_TOL`` = 5e-6 for the SHEARLET
basis, whose windows sum more float32 terms a coefficient (2.1e-6
measured padded, 3.0e-6 unpadded). Hard thresholds flip
coefficients at the threshold under reordered arithmetic, so that solve
is held by SNR against the dense truth within ``SNR_TOL_DB``."""

import dataclasses
import importlib
import logging

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.parallel import solver as jsolver
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_tpu.utils import pad as jpad
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.models.pocs import (TPU_ONLY_FIELDS,
                                                       POCSConfig)
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.parallel import solver
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe
from pseudo_3d_interpolation_torch.utils import pad

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

TOL = 2.5e-6
SHEARLET_TOL = 5e-6
SNR_TOL_DB = 0.1
H, W, F = 100, 120, 4
SOFT = dict(niter=10, p_min=1e-3, version="fast", alpha=0.75,
            thresh_op="soft")


def _problem(f=F, h=H, w=W, seed=0):
    """Four random plane waves a slice over ``h``×``w`` (not periodic on
    the grid) and a mask of whole traces, about half of them kept."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((f, h, w), np.complex64)
    for i in range(f):
        for _ in range(4):
            fy, fx = rng.integers(1, 7, size=2)
            truth[i] += np.exp(2j * np.pi * (fy * yy / h + fx * xx / w)
                               + 1j * rng.uniform(0, 2 * np.pi))
    keep = rng.uniform(size=w) < 0.5
    mask = np.ascontiguousarray(np.broadcast_to(keep[None, :], (h, w)),
                                np.float32)
    return truth, mask


def _snr(truth, x):
    return 10 * np.log10(np.sum(np.abs(truth) ** 2)
                         / np.sum(np.abs(truth - x) ** 2))


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- the automatic rule, the cases of JAX tests/test_pad_tile.py:146 ---
_RULE_CASES = [
    ({}, 500, 380), ({}, 120, 120), ({}, 72, 40), ({}, 300, 200),
    ({}, 512, 384), ({"use_pallas": False}, 500, 380),
    ({"transform_kind": "SHEARLET"}, 500, 380),
    ({"thresh_op": "energy"}, 500, 380), ({"eps": 1e-9}, 500, 380),
    ({"global_early_stop": True}, 500, 380),
    ({"keep_cost_history": True}, 500, 380),
    ({"version": "adaptive"}, 500, 380),
    ({"pad_to_tile": True}, 72, 40), ({"pad_to_tile": False}, 500, 380),
    ({"pad_to_tile": True}, 512, 384),
]


@pytest.mark.parametrize("kw,h,w", _RULE_CASES)
def test_auto_pad_to_tile_rule_matches_jax_off_a_tpu(kw, h, w):
    """The JAX rule with its kernel gate answered as off a TPU (no
    interpret mode): ``None`` never pads, ``True``/``False`` override."""
    jcfg = jpocs.POCSConfig(**{"use_pallas": True, "eps": 0.0, **kw})
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    want = jpad.auto_pad_to_tile(jcfg, h, w)
    assert pad.auto_pad_to_tile(cfg, h, w) is want
    assert want is bool(kw.get("pad_to_tile", False))
    side = (pad.next_multiple(h, 128), pad.next_multiple(w, 128))
    assert pad.padded_shape(cfg, h, w) == (side if want else (h, w))


@pytest.mark.parametrize("n,m", [(1, 128), (100, 128), (128, 128),
                                 (129, 128), (500, 128), (7, 3), (0, 8)])
def test_tile_arithmetic_matches_jax(n, m):
    assert pad.next_multiple(n, m) == jpad.next_multiple(n, m)
    assert pad.next_pow2(n) == jpad.next_pow2(n)
    if n:
        assert pad.pad_area_ratio(n, n + 3, m) == jpad.pad_area_ratio(
            n, n + 3, m)
    assert pad.PAD_TO_TILE_MAX_AREA == jpad.PAD_TO_TILE_MAX_AREA


@pytest.mark.parametrize("shape", [(2, 60, 45), (3, 100, 120), (1, 128, 256),
                                   (2, 2, 130, 70)])
def test_pad_slices_to_tile_matches_jax(shape):
    rng = np.random.default_rng(1)
    data = (rng.normal(size=shape)
            + 1j * rng.normal(size=shape)).astype(np.complex64)
    mask = (rng.uniform(size=shape[-2:]) < 0.5).astype(np.float32)
    got = pad.pad_slices_to_tile(data, mask)
    want = jpad.pad_slices_to_tile(data, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if shape[-2] % 128 == 0 and shape[-1] % 128 == 0:
        assert got[0] is data  # aligned: no copy
    else:  # the frame: amplitude 0, mask 1
        h, w = shape[-2:]
        assert not got[0][..., h:, :].any() and not got[0][..., w:].any()
        assert (got[1][h:] == 1).all() and (got[1][:, w:] == 1).all()


@pytest.mark.parametrize("n,zeros", [(5, False), (4, True), (0, False),
                                     (1, False)])
def test_pad_mirror_flip_matches_jax(n, zeros):
    a = np.random.default_rng(2).normal(size=37).astype(np.float32)
    np.testing.assert_array_equal(
        pad.pad_mirror_flip(a, n, zeros).numpy(),
        np.asarray(jpad.pad_mirror_flip(a, n, zeros)))


@pytest.mark.parametrize("mode,kw", [("constant", {}),
                                     ("constant", {"constant_values": 2.5}),
                                     ("edge", {}), ("reflect", {}),
                                     ("symmetric", {}), ("wrap", {})])
@pytest.mark.parametrize("axis,n", [(-1, 3), (0, (2, 5)), (1, (0, 4))])
def test_pad_along_axis_matches_jax(mode, kw, axis, n):
    a = np.random.default_rng(3).normal(size=(9, 14)).astype(np.float32)
    np.testing.assert_array_equal(
        pad.pad_along_axis(a, n, mode, axis, **kw).numpy(),
        np.asarray(jpad.pad_along_axis(a, n, mode, axis, **kw)))


def test_pad_to_shape_and_slice_valid_data_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    for shape in ((5, 7), (8, 7), (9, 16)):
        np.testing.assert_array_equal(pad.pad_to_shape(a, shape).numpy(),
                                      np.asarray(jpad.pad_to_shape(a, shape)))
    np.testing.assert_array_equal(
        pad.pad_to_shape(a, (6, 9), "edge").numpy(),
        np.asarray(jpad.pad_to_shape(a, (6, 9), "edge")))
    with pytest.raises(ValueError, match="smaller"):
        pad.pad_to_shape(a, (4, 7))
    nso, extra = 50, 12
    data = np.zeros((nso + extra, 8), np.float32)
    for j, s in enumerate(rng.integers(0, extra, size=8)):
        data[s:s + nso, j] = rng.normal(size=nso) + 10.0
    got, got_idx = pad.slice_valid_data(data, nso)
    want, want_idx = jpad.slice_valid_data(data, nso)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("kind", ["FFT", "DCT", "SHEARLET"])
@pytest.mark.parametrize("driver", ["resident", "host-chunked"])
def test_pad_to_tile_matches_jax_with_a_soft_threshold(kind, driver):
    truth, mask = _problem()
    obs = truth * mask
    kw = dict(SOFT, transform_kind=kind, pad_to_tile=True)
    jcfg, cfg = jpocs.POCSConfig(**kw), POCSConfig(**kw)
    if driver == "resident":
        want = jsolver.interpolate_cube_resident(obs, mask, jcfg,
                                                 transform=jget(kind),
                                                 batch=F)
        got = solver.interpolate_cube_resident(obs, mask, cfg,
                                               transform=get_transform(kind),
                                               batch=F, device="cpu")
    else:
        want = jsolver.interpolate_cube(obs, mask, jcfg, mesh=make_mesh(),
                                        transform=jget(kind), batch=F)
        got = solver.interpolate_cube(obs, mask, cfg,
                                      transform=get_transform(kind), batch=3,
                                      device="cpu")
    assert got[0].shape == (F, H, W)
    tol = SHEARLET_TOL if kind == "SHEARLET" else TOL
    assert _max_rel(got[0], want[0]) <= tol, _max_rel(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the padded problem is another one: its result is not the unpadded
    unpadded = solver.interpolate_cube_resident(
        obs, mask, dataclasses.replace(cfg, pad_to_tile=None),
        transform=get_transform(kind), batch=F, device="cpu")
    assert _max_rel(got[0], unpadded[0]) > 1e-3


@pytest.mark.parametrize("kind", ["FFT", "DCT"])
def test_pad_to_tile_matches_jax_snr_with_a_hard_threshold(kind):
    truth, mask = _problem(seed=5)
    obs = truth * mask
    kw = dict(niter=20, thresh_op="hard", thresh_model="exponential",
              p_min=1e-3, version="fast", alpha=0.75, transform_kind=kind,
              pad_to_tile=True)
    want = jsolver.interpolate_cube_resident(obs, mask, jpocs.POCSConfig(**kw),
                                             batch=F)[0]
    got = solver.interpolate_cube_resident(obs, mask, POCSConfig(**kw),
                                           batch=F, device="cpu")[0]
    assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    assert _snr(truth, got) > _snr(truth, obs) + 3.0


@pytest.mark.parametrize("driver", [solver.interpolate_cube_resident,
                                    solver.interpolate_cube])
def test_pad_to_tile_none_and_false_solve_the_slices_as_they_are(driver):
    truth, mask = _problem(f=3)
    obs = truth * mask
    results = [driver(obs, mask, POCSConfig(**SOFT, pad_to_tile=p),
                      batch=2, device="cpu") for p in (None, False)]
    no_field = driver(obs, mask, POCSConfig(**SOFT), batch=2, device="cpu")
    for res in results:
        for a, b in zip(res, no_field):
            np.testing.assert_array_equal(a, b)
    # and real slices stay real through the padded solve
    real = driver(obs.real.copy(), mask, POCSConfig(**SOFT, pad_to_tile=True),
                  batch=2, device="cpu")[0]
    assert real.dtype == np.float32 and real.shape == (3, H, W)


def test_yaml_pad_to_tile_is_carried_and_interpolate_matches_jax(caplog):
    """``pad_to_tile: true`` in a POCS YAML reaches the drivers (it was
    dropped as TPU-only before) and gives the JAX package's cube."""
    from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
    from pseudo_3d_interpolation_torch.io.cube import Cube

    meta = dict(SOFT, transform_kind="FFT", pad_to_tile=True)
    cfg, extra = pipe.config_from_yaml({"metadata": meta})
    jcfg, _ = jpipe.config_from_yaml({"metadata": meta})
    assert cfg.pad_to_tile is True and extra == {}
    assert cfg == compat.config_from_reference(dataclasses.asdict(jcfg))
    assert "pad_to_tile" not in TPU_ONLY_FIELDS
    truth, mask = _problem()
    amp = np.moveaxis(truth * mask, 0, -1)
    coords = {"iline": np.arange(H), "xline": np.arange(W),
              "freq": np.arange(F, dtype=np.float64)}
    fold = mask.astype(np.int32)
    jout = jpipe.interpolate(JCube(coords=dict(coords), data_vars={
        "amp": (("iline", "xline", "freq"), amp),
        "fold": (("iline", "xline"), fold)}), {"metadata": meta}, batch=F)
    with caplog.at_level(logging.DEBUG):
        out = pipe.interpolate(Cube(coords=dict(coords), data_vars={
            "amp": (("iline", "xline", "freq"), amp),
            "fold": (("iline", "xline"), fold)}), {"metadata": meta},
            batch=F, device="cpu")
    assert "(pad_to_tile engaged)" in caplog.text
    got, want = out["amp_interp"], np.asarray(jout["amp_interp"])
    assert got.shape == (H, W, F)
    assert _max_rel(got, want) <= TOL


def test_the_budget_and_the_directional_plan_take_the_padded_grid(
        monkeypatch):
    """``interpolate``'s driver choice budgets the solved (padded) sides,
    and a SHEARLET solve builds its plan for them."""
    cfg = POCSConfig(**SOFT, transform_kind="SHEARLET", pad_to_tile=True)
    tr = get_transform("SHEARLET")
    seen = {}

    def fits(device, n_slices, batch, h, w, expansion=1, extra_bytes=0):
        seen.update(h=h, w=w, extra=extra_bytes)
        return True
    monkeypatch.setattr(pipe, "fits_resident", fits)
    resident, b, solved = pipe._driver_plan(cfg, tr, 10, H, W, 64, "cpu")
    assert resident and b == 32 and solved == (128, 128)
    assert (seen["h"], seen["w"]) == (128, 128)
    assert seen["extra"] == pipe._transform_device_bytes(tr, 32, 128, 128)
    plans = []
    real = type(tr)._plan

    def spy(self, h, w):
        plans.append((h, w))
        return real(self, h, w)
    monkeypatch.setattr(type(tr), "_plan", spy)
    truth, mask = _problem(f=2)
    solver.interpolate_cube_resident(truth * mask, mask, cfg, transform=tr,
                                     batch=2, device="cpu")
    assert plans and set(plans) == {(128, 128)}
