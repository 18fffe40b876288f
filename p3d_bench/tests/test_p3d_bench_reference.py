"""The plain reference and the seeded cube at a tiny size on the CPU,
against the port's ``device="cpu"`` path and the north-star runner's
numpy cube."""

from __future__ import annotations

import importlib.util

import numpy as np
import pytest
import torch

import bench_tiny
from p3d_bench import harness
from p3d_bench.reference import cube as ref_cube
from p3d_bench.reference import pocs as ref_pocs
from p3d_bench.reference import shearlet as sh


def _runner():
    path = bench_tiny.ROOT / "examples" / "northstar_run_torch.py"
    spec = importlib.util.spec_from_file_location("northstar_runner", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cube_without_jitter_is_the_runners():
    cfg = dict(bench_tiny.tiny_cell("shearlet_cube_1chip").config,
               jitter=0.0)
    runner = _runner()
    truth, _, _ = runner.synthetic_cube(*cfg["shape"], keep=0.5, workers=1)
    ours = ref_cube.dense_cube(cfg, seed=5, device="cpu", block=7).numpy()
    np.testing.assert_allclose(ours, truth, rtol=0, atol=2e-6)
    assert cfg["dt_s"] == runner.DT
    assert [tuple(r) for r in cfg["reflectors"]] == list(runner.REFLECTORS)


def test_seed_deals_geometry_and_draws_mask():
    cfg = bench_tiny.tiny_cell("shearlet_cube_1chip").config
    big = 2**31 + 12345
    geos = [ref_cube.geometry(cfg, big + k) for k in range(12)]
    assert geos[0] == ref_cube.geometry(cfg, big)
    assert len({tuple(g) for g in geos}) > 3  # seeds deal other orders
    span = cfg["shape"][2] * cfg["dt_s"]
    j = cfg["jitter"]
    for geo in geos:
        factors = [[], [], []]
        for (onset, amp, f0, dil, dxl), (frac, amp0, f00) in zip(
                geo, cfg["reflectors"]):
            factors[0].append(onset / (frac * span))
            factors[1].append(dil / (cfg["dips"][0] * span))
            factors[2].append(dxl / (cfg["dips"][1] * span))
            assert (amp, f0) == (amp0, f00)
        for f in factors:  # the same three factors, in some order
            assert sorted(f) == pytest.approx([1 - j, 1.0, 1 + j])
    m = ref_cube.bin_mask(cfg, big, "cpu")
    assert torch.equal(m, ref_cube.bin_mask(cfg, big, "cpu"))
    assert 0.35 < float(m.mean()) < 0.65
    assert set(m.unique().tolist()) <= {0.0, 1.0}


def test_time_spectrum_matches_the_ports_forward_fft():
    from pseudo_3d_interpolation_torch.ops import spectral

    x = torch.randn(3, 4, 64, dtype=torch.float32)
    dt = 0.25e-3
    ours = ref_pocs.time_spectrum(x, dt, torch.arange(33))
    port = spectral.forward_fft(x, np.arange(64) * dt).data
    np.testing.assert_allclose(ours.real.movedim(0, -1).numpy(),
                               port.re.numpy(), atol=2e-9)
    np.testing.assert_allclose(ours.imag.movedim(0, -1).numpy(),
                               port.im.numpy(), atol=2e-9)


@pytest.mark.parametrize("cell", ["shearlet_cube_1chip",
                                  "fft_eps_cube_1chip"])
def test_reference_solve_matches_the_ports_cpu_path(cell):
    from pseudo_3d_interpolation_torch.models.pocs import pocs_interpolate
    from pseudo_3d_interpolation_torch.models.transforms import get_transform
    from pseudo_3d_interpolation_torch.ops.cplx import Cplx

    cfg = bench_tiny.tiny_cell(cell).config
    inputs = harness.make_inputs(cfg, 77, "cpu")
    spec = harness.obs_spectrum(inputs.obs, cfg["dt_s"], "cpu")
    energy = (spec.abs() ** 2).sum(dim=(-2, -1))
    z = spec[torch.argsort(energy, descending=True)[:8]]  # signal slices
    mask = torch.from_numpy(inputs.mask)
    ref, _ = ref_pocs.solve_slices(z, mask, cfg, "float64")
    zc = z.to(torch.complex64)
    port = pocs_interpolate(Cplx(zc.real.contiguous(), zc.imag.contiguous()),
                            mask, get_transform(cfg["basis"]),
                            harness.port_config(cfg)).data
    got = torch.complex(port.re, port.im).to(torch.complex128)
    rel = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    # a hard threshold flips on rounding: sound float32 solves read up to
    # 1.3e-4 here, the reference in TF32 1.2e-3 to 3.0e-3
    assert rel < 5e-4


@pytest.mark.parametrize("cell", ["shearlet_cube_1chip",
                                  "fft_eps_cube_1chip"])
def test_check_reads_the_ports_cube_as_the_reference(cell):
    c = bench_tiny.tiny_cell(cell)
    inputs = harness.make_inputs(c.config, 3, "cpu")
    mesh = harness.make_mesh(harness.Ranks(), "cpu")
    res, walls = harness.cube_runner(c.config, inputs, mesh)()
    out = res.data_vars["amp"][1]
    numbers = harness.check_numbers(c.config, c.check, inputs, out, 3, "cpu")
    assert numbers["rel_l2"] < 1e-5
    assert len(numbers["bins"]) == bench_tiny.SLICES
    # the laps' walls, the harness's host-to-host wall, and stage 2's
    # spans and build counters
    assert set(walls) == {"upload", "solve", "download", "cube", "spans",
                          "process"}
    snr, snr_mag = ref_pocs.snr_db(inputs.truth, out)
    assert snr > ref_pocs.snr_db(inputs.truth, inputs.obs)[0] + 10
    assert np.isfinite(snr_mag)


def test_transform_keys_reach_the_program_and_the_reference():
    """A tiny ``shearlet_cube_1chip`` whose configuration states its
    default ``n_scales`` as a transform key: the program's cube and the
    reference's solve are bit-equal to the same cell's without it."""
    c = bench_tiny.tiny_cell("shearlet_cube_1chip")
    h, w, _ = c.config["shape"]
    keyed = dict(c.config, transform={"n_scales": sh.default_scales(h, w)})
    inputs = harness.make_inputs(c.config, 11, "cpu")
    mesh = harness.make_mesh(harness.Ranks(), "cpu")
    spec = harness.obs_spectrum(inputs.obs, c.config["dt_s"], "cpu")
    z = spec[torch.argsort((spec.abs() ** 2).sum(dim=(-2, -1)),
                           descending=True)[:4]]
    mask = torch.from_numpy(inputs.mask)
    cubes, solves = [], []
    for cfg in (c.config, keyed):
        res, _ = harness.cube_runner(cfg, inputs, mesh)()
        cubes.append(res.data_vars["amp"][1])
        solves.append(ref_pocs.solve_slices(z, mask, cfg, "float64"))
    assert np.array_equal(cubes[0], cubes[1])
    assert torch.equal(solves[0][0], solves[1][0])
    assert torch.equal(solves[0][1], solves[1][1])
    # and the key reaches both sides: another scale count moves each
    other = dict(c.config, transform={"n_scales": sh.default_scales(h, w) - 1})
    res, _ = harness.cube_runner(other, inputs, mesh)()
    assert not np.array_equal(res.data_vars["amp"][1], cubes[0])
    assert not torch.equal(ref_pocs.solve_slices(z, mask, other)[0],
                           solves[0][0])


def test_eps_freezes_converged_slices():
    cfg = dict(bench_tiny.tiny_cell("fft_eps_cube_1chip").config,
               eps=1e-2, niter=20)
    z = torch.zeros(3, 16, 16, dtype=torch.complex128)
    z[0, 3, 4] = 1.0
    z[1] = torch.randn(16, 16, dtype=torch.complex128)
    mask = (torch.rand(16, 16) < 0.5).to(torch.float64)
    tr = ref_pocs.Transforms("float64")
    out, iters = ref_pocs.fpocs(z, mask,
                                ref_pocs.basis_for(cfg, 16, 16, tr, "cpu"),
                                cfg)
    assert int(iters[2]) == 0 and torch.equal(out[2], z[2])  # zero slice
    assert 4 <= int(iters[0]) < 20  # a single spike converges early


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0],
                     dtype=torch.float32)
    r = ref_pocs.round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0]
    c = ref_pocs.round_tf32(torch.complex(x, -x))
    assert torch.equal(c.real, r) and torch.equal(c.imag, -r)
