"""The slice × space mesh over ``torch.distributed`` on a gloo group of
4 × 2 = 8 spawned CPU processes: ``parallel.mesh.make_mesh_2d`` and
``pocs_interpolate_sharded`` on it, the FFT basis solved as a distributed
line FFT (``parallel.solver.SpaceShardedFFT``).

The configuration and inputs are the JAX package's own 2-D mesh test
(tests/test_parallel.py::test_2d_mesh_slices_by_space: 8 plane-wave
slices of 64², half the columns kept, niter 10, p_min 1e-3, FPOCS), with
the slices over the "slices" axis and the ilines over "space", as JAX
places them (``P("slices", "space", None)``, mask ``P("space", None)``).

Tolerances: against the port's ``pocs_interpolate_numpy`` (one process,
the folded solve's plain version) at the JAX test's rtol 1e-3 and atol
1e-4; against the one-process port within 1e-5 of the largest value
(the line FFTs and the all_reduced sums round otherwise than
``torch.fft.fft2`` and one process's sums: about 1e-6 here, no hard
threshold flipping on these plane waves). The iteration counts are
held equal. The ``*-percentile`` variants (JAX tests/test_pocs.py:189-199's
setting) are held against the JAX package's solve as
``test_torch_percentile.py`` holds the one-process port: soft within
1e-4 of max, hard by SNR against the plane waves within 0.1 dB (a hard
cut at a percentile lies on a coefficient's own value, so a rounding
flips it); soft also at the tolerances above, hard by SNR against the
one-process port.

DCT, WAVELET, SHEARLET and CURVELET (SHEARLET also with
``hard-percentile``) spread whole slices over the mesh's 8 ranks: each is
bit-equal to ``make_mesh(8)`` and held to the JAX package's solve at the
same per-rank batch by SNR within 0.1 dB (hard thresholds); a batch of 4
pads on to the grid. Stage 2 on the 4 × 2 mesh runs over the grid:
bit-equal to ``make_mesh(8)``, and within ``test_torch_sharding.py``'s
tolerance of the JAX package's sharded stage 2 (soft threshold).

The drivers above the solve (``interpolate``, on FFT and SHEARLET,
``interpolate_checkpointed`` with its resume, ``warmup``) run on the
4 × 2 mesh; and a 2-D mesh of one space rank (``make_mesh_2d(8, 1)``) is
the 1-D path bit for bit, FFT, DCT and stage 2.
"""

import importlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_torch.models.pocs import (POCSConfig,
                                                       pocs_interpolate_numpy)
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib
from pseudo_3d_interpolation_torch.parallel import solver

from test_pocs import random_mask, synthetic_slice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
N_SLICES, N_SPACE = 4, 2
JAX_RTOL, JAX_ATOL = 1e-3, 1e-4  # tests/test_parallel.py:113
ONE_PROCESS_TOL = 1e-5  # of max|one process|
BASE_CFG = dict(niter=10, p_min=1e-3, version="fast")
VARIANTS = {
    "fast": {},
    "regular": dict(version="regular"),
    "adaptive": dict(version="adaptive", alpha=0.75),
    "fast eps": dict(eps=1e-3),
    "fast history": dict(keep_cost_history=True),
    "soft adaptive p_min": dict(thresh_op="soft", p_min="adaptive"),
    "soft inverse_proportional": dict(thresh_op="soft",
                                      thresh_model="inverse_proportional"),
    "soft data-driven": dict(thresh_op="soft", thresh_model="data-driven"),
    "global early stop": dict(eps=1e-2, global_early_stop=True),
    # JAX tests/test_pocs.py:189-199's percentile setting
    "hard-percentile": dict(thresh_op="hard-percentile",
                            decay_kind="factors", p_max=99.9, p_min=60.0),
    "soft-percentile": dict(thresh_op="soft-percentile",
                            decay_kind="factors", p_max=99.9, p_min=60.0),
}
PERCENTILE_SOFT_TOL = 1e-4  # of max|JAX|, test_torch_percentile.py's
HARD_SNR_DB = 0.1  # hard-percentile by SNR, test_torch_percentile.py's
# the bases that spread whole slices over the grid of a split 2-D mesh,
# in the production hard threshold, and SHEARLET with a percentile one
BASES = {
    "DCT": dict(transform_kind="DCT"),
    "WAVELET": dict(transform_kind="WAVELET"),
    "SHEARLET": dict(transform_kind="SHEARLET"),
    "CURVELET": dict(transform_kind="CURVELET"),
    "SHEARLET hard-percentile": dict(transform_kind="SHEARLET",
                                     **VARIANTS["hard-percentile"]),
}
# stage 2 on the split mesh: test_torch_sharding.py's configuration and
# tolerance against the JAX package's sharded stage 2
STAGE2_CFG = dict(niter=10, thresh_op="soft", thresh_model="exponential",
                  p_min=1e-3, version="fast", alpha=0.75, eps=0.0)
STAGE2_ATOL, STAGE2_RTOL = 2e-5, 1e-4  # of max|JAX|, and relative
TWT = np.arange(16) * 0.25e-3

WORKER = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from pseudo_3d_interpolation_torch.models.pocs import (POCSConfig,
                                                       pocs_interpolate)
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.parallel import mesh as M
from pseudo_3d_interpolation_torch.parallel import solver as S

port, rank, world, ns, nsp, work = sys.argv[1:7]
rank, world, ns, nsp = int(rank), int(world), int(ns), int(nsp)
M.initialize_distributed(coordinator=f"127.0.0.1:{port}",
                         num_processes=world, process_id=rank,
                         backend="gloo")
mesh = M.make_mesh_2d(ns, nsp)
inputs = np.load(os.path.join(work, "inputs.npz"), allow_pickle=True)
obs, mask = inputs["obs"], inputs["mask"]
variants = inputs["variants"].item()
z = Cplx(torch.from_numpy(obs.real.copy()), torch.from_numpy(obs.imag.copy()))
out = {"layout": np.array([mesh.slices.index, mesh.space.index,
                           mesh.slices.size, mesh.space.size,
                           mesh.size, mesh.slice_shards]),
       "slice ranks": np.array(mesh.slices.ranks),
       "space ranks": np.array(mesh.space.ranks)}
for name, cfg_kw in variants.items():
    res = S.pocs_interpolate_sharded(z, mask, mesh,
                                     config=POCSConfig(**cfg_kw))
    out[name] = np.stack([res.data.re.numpy(), res.data.im.numpy()])
    out[name + " iters"] = res.n_iterations.numpy()
    out[name + " cost"] = res.cost.numpy()
    if res.cost_history is not None:
        out[name + " history"] = res.cost_history.numpy()
# every other basis spreads whole slices over the grid: the 1-D mesh of
# the same ranks, slice for slice
flat, line = M.make_mesh_2d(world, 1), M.make_mesh(world)
for name, cfg_kw in inputs["bases"].item().items():
    for mname, m in (("grid", mesh), ("1-D", line)):
        res = S.pocs_interpolate_sharded(z, mask, m,
                                         config=POCSConfig(**cfg_kw))
        out[f"{name} {mname}"] = np.stack([res.data.re.numpy(),
                                           res.data.im.numpy()])
        out[f"{name} {mname} iters"] = res.n_iterations.numpy()
        out[f"{name} {mname} cost"] = res.cost.numpy()
# a batch of the slice axis (4) but not of the grid (8): padded on to the
# grid inside, each slice solved alone
dct = POCSConfig(**inputs["bases"].item()["DCT"])
res = S.pocs_interpolate_sharded(Cplx(z.re[:4], z.im[:4]), mask, mesh,
                                 config=dct)
out["DCT 4"] = np.stack([res.data.re.numpy(), res.data.im.numpy()])
alone = [pocs_interpolate(Cplx(z.re[i:i + 1], z.im[i:i + 1]),
                            torch.from_numpy(mask), config=dct)
         for i in range(4)]
out["DCT 4 alone"] = np.stack([np.concatenate([r.data.re.numpy()
                                               for r in alone]),
                               np.concatenate([r.data.im.numpy()
                                               for r in alone])])
cfg = POCSConfig(**variants["fast"])
rec, it, cost = S.interpolate_cube(obs[:5], mask, cfg, batch=3, mesh=mesh)
out["cube"], out["cube iters"] = rec, it

# the drivers above the solve: in memory, checkpointed and resumed, warmup
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.pipeline import pocs as P
from pseudo_3d_interpolation_torch.pipeline.stage2 import (
    interpolate_time_cube_sharded)

h, w = obs.shape[1:]
grid = {"iline": np.arange(h), "xline": np.arange(w)}
fold = (("iline", "xline"), mask.astype(np.int32))
cube = Cube(coords=dict(grid, freq=np.arange(5.0)),
            data_vars={"amp": (("iline", "xline", "freq"),
                               np.ascontiguousarray(
                                   np.moveaxis(obs[:5], 0, -1))),
                       "fold": fold})
out["interpolate"] = P.interpolate(cube, cfg, mesh=mesh,
                                   batch=3).data_vars["amp_interp"][1]
shearlet = POCSConfig(**inputs["bases"].item()["SHEARLET"])
out["interpolate SHEARLET"] = P.interpolate(
    cube, shearlet, mesh=mesh, batch=3).data_vars["amp_interp"][1]
ck = os.path.join(work, "checkpoints")
out["checkpointed"] = P.interpolate_checkpointed(
    cube, cfg, ck, mesh=mesh, batch=3).data_vars["amp_interp"][1]
out["resumed"] = P.interpolate_checkpointed(
    cube, cfg, ck, mesh=mesh, batch=3).data_vars["amp_interp"][1]
out["warmup ran"] = np.array(P.warmup(cfg, (h, w), batch=3, mesh=mesh,
                                      n_slices=5) > 0)

# stage 2 on the split mesh: the three stages over the grid
tcube = Cube(coords=dict(grid, twt=inputs["twt"]),
             data_vars={"amp": (("iline", "xline", "twt"), inputs["tamp"]),
                        "fold": fold})
stage2 = POCSConfig(**inputs["stage2"].item())
for name, m in (("grid", mesh), ("1-D", line)):
    out[f"stage2 soft {name}"] = interpolate_time_cube_sharded(
        tcube, stage2, mesh=m).data_vars["amp"][1]

# a 2-D mesh of one space rank is the 1-D slice path: every basis, and
# stage 2, as on the 1-D mesh of the same ranks
for kind in ("FFT", "DCT"):
    kcfg = POCSConfig(transform_kind=kind, **variants["fast"])
    for name, m in (("flat", flat), ("1-D", line)):
        res = S.pocs_interpolate_sharded(z, mask, m, config=kcfg)
        out[f"{kind} {name}"] = np.stack([res.data.re.numpy(),
                                          res.data.im.numpy()])
for name, m in (("flat", flat), ("1-D", line)):
    out[f"stage2 {name}"] = interpolate_time_cube_sharded(
        tcube, cfg, mesh=m).data_vars["amp"][1]
np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs():
    obs = np.stack([synthetic_slice(seed=s) for s in range(8)])
    mask = random_mask(frac=0.5, seed=20)
    return (obs * mask).astype(np.complex64), np.ascontiguousarray(mask)


def _snr_of(truth, x) -> float:
    return 10 * np.log10(np.sum(np.abs(truth) ** 2)
                         / np.sum(np.abs(truth - x) ** 2))


def _snr(x) -> float:
    """dB of the plane waves ``_inputs`` observes against their gap to
    ``x``."""
    return _snr_of(np.stack([synthetic_slice(seed=s) for s in range(8)]), x)


def _config(name: str) -> POCSConfig:
    return POCSConfig(**dict(BASE_CFG, **VARIANTS[name]))


def _time_amp(mask):
    """The stage-2 time cube: seeded noise on the observed bins, 16
    samples a trace."""
    rng = np.random.default_rng(5)
    return (rng.normal(size=mask.shape + (16,)) * mask[..., None]
            ).astype(np.float32)


def _obj(value):
    box = np.empty((), dtype=object)
    box[()] = value
    return box


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the worker on the 8 ranks of a 4 x 2 mesh; each rank's
    results."""
    work = tmp_path_factory.mktemp("mesh2d")
    obs, mask = _inputs()
    np.savez(os.path.join(work, "inputs.npz"), obs=obs, mask=mask,
             variants=_obj({k: dict(BASE_CFG, **v)
                            for k, v in VARIANTS.items()}),
             bases=_obj({k: dict(BASE_CFG, **v) for k, v in BASES.items()}),
             stage2=_obj(STAGE2_CFG), twt=TWT, tamp=_time_amp(mask))
    world = N_SLICES * N_SPACE
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(port), str(r), str(world),
         str(N_SLICES), str(N_SPACE), str(work)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank of the {world}-process group hung past "
                    f"{GROUP_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [dict(np.load(os.path.join(work, f"rank{r}.npz"),
                         allow_pickle=True)) for r in range(world)]


def test_mesh_2d_layout(group):
    """Rank i·n_space + j sits at slice block i and iline block j; its
    slice-axis group holds column j of the grid, its space group row i."""
    for r, res in enumerate(group):
        i, j = divmod(r, N_SPACE)
        assert res["layout"].tolist() == [i, j, N_SLICES, N_SPACE,
                                          N_SLICES * N_SPACE, N_SLICES]
        assert res["slice ranks"].tolist() == [k * N_SPACE + j
                                               for k in range(N_SLICES)]
        assert res["space ranks"].tolist() == [i * N_SPACE + k
                                               for k in range(N_SPACE)]


def test_every_rank_returns_the_whole_result(group):
    for other in group[1:]:
        for k, v in group[0].items():
            if k not in ("layout", "slice ranks", "space ranks"):
                np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_space_sharded_fft_solve_matches_one_process(group, name):
    obs, mask = _inputs()
    cfg = _config(name)
    got = group[0][name]
    got_c = got[0] + 1j * got[1]
    rec, iters, cost = pocs_interpolate_numpy(obs, mask, cfg, device="cpu")
    if cfg.thresh_op == "hard-percentile":
        # a hard cut at a percentile sits on a coefficient's own value, so
        # a rounding flips it (the one-process port and JAX differ by
        # 6e-3 of max here): held by SNR, as against JAX
        assert abs(_snr(got_c) - _snr(rec)) < HARD_SNR_DB
        np.testing.assert_array_equal(group[0][name + " iters"], iters)
        return
    # the JAX test's tolerance, against the port's numpy entry point
    np.testing.assert_allclose(got_c, rec, rtol=JAX_RTOL, atol=JAX_ATOL)
    # and the one-process port, tighter
    scale = np.abs(rec).max()
    assert np.abs(got_c - rec).max() <= ONE_PROCESS_TOL * scale
    np.testing.assert_array_equal(group[0][name + " iters"], iters)
    np.testing.assert_allclose(group[0][name + " cost"], cost, rtol=1e-3,
                               atol=1e-9)
    if cfg.keep_cost_history:
        one = solver.pocs_interpolate_sharded(
            Cplx(torch.from_numpy(obs.real.copy()),
                 torch.from_numpy(obs.imag.copy())), mask,
            mesh_lib.make_mesh_2d(1, 1, device="cpu"), config=cfg)
        np.testing.assert_allclose(group[0][name + " history"],
                                   one.cost_history.numpy(), rtol=1e-3,
                                   atol=1e-9)


@pytest.mark.parametrize("op", ["hard-percentile", "soft-percentile"])
def test_percentile_solve_matches_jax(group, op):
    """The ``*-percentile`` thresholds rank the whole slice's magnitudes
    on every rank of its space group, as XLA's partitioned percentile
    does: the 2-D mesh's solve against the JAX package's on the same
    inputs. Soft within 1e-4 of max|JAX|; hard, whose flips near the
    threshold move single coefficients, by SNR against the plane waves
    within 0.1 dB, as ``test_torch_percentile.py`` holds them."""
    jax_numpy = pytest.importorskip("jax.numpy")
    jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")
    from pseudo_3d_interpolation_tpu.models.transforms import (
        get_transform as jget)
    from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx

    obs, mask = _inputs()
    kw = dict(BASE_CFG, **VARIANTS[op])
    jres = jpocs.pocs_interpolate(
        JCplx(jax_numpy.asarray(obs.real), jax_numpy.asarray(obs.imag)),
        jax_numpy.asarray(mask), jget("FFT"), jpocs.POCSConfig(**kw))
    want = np.asarray(jres.data.re) + 1j * np.asarray(jres.data.im)
    got = group[0][op][0] + 1j * group[0][op][1]
    if op == "hard-percentile":
        assert _snr(got) > _snr(obs)
        assert abs(_snr(got) - _snr(want)) < HARD_SNR_DB
    else:
        assert (np.abs(got - want).max()
                <= PERCENTILE_SOFT_TOL * np.abs(want).max())
    np.testing.assert_array_equal(group[0][op + " iters"],
                                  np.asarray(jres.n_iterations))


@pytest.mark.parametrize("name", list(BASES))
def test_other_bases_on_a_2d_mesh_are_the_1d_mesh(group, name):
    """DCT, WAVELET, SHEARLET and CURVELET (and SHEARLET with a
    percentile threshold) spread whole slices over the 4 x 2 mesh's grid:
    bit-equal to ``make_mesh(8)`` over the same ranks, result, iterations
    and cost."""
    for key in ("", " iters", " cost"):
        np.testing.assert_array_equal(group[0][f"{name} grid{key}"],
                                      group[0][f"{name} 1-D{key}"])


def _jax_solve(obs, mask, cfg_kw, per_call):
    """The JAX package's ``pocs_interpolate`` (its plain reference, as its
    own CPU tests run it) on ``obs``, ``per_call`` slices a call: the
    results and the iteration counts."""
    jnp = pytest.importorskip("jax.numpy")
    jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")
    from pseudo_3d_interpolation_tpu.models.transforms import (
        get_transform as jget)
    from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx

    jax = pytest.importorskip("jax")
    cfg = jpocs.POCSConfig(**cfg_kw)
    transform = jget(cfg.transform_kind)
    solve = jax.jit(lambda re, im, m: jpocs.pocs_interpolate(
        JCplx(re, im), m, transform, cfg))
    recs, iters = [], []
    for i in range(0, obs.shape[0], per_call):
        part = obs[i:i + per_call]
        res = solve(jnp.asarray(part.real), jnp.asarray(part.imag),
                    jnp.asarray(mask))
        recs.append(np.asarray(res.data.re) + 1j * np.asarray(res.data.im))
        iters.append(np.asarray(res.n_iterations))
    return np.concatenate(recs), np.concatenate(iters)


@pytest.mark.parametrize("name", list(BASES))
def test_other_bases_on_a_2d_mesh_match_jax(group, name):
    """The same solves against the JAX package's ``pocs_interpolate`` at
    the same per-rank batch (one slice): a hard threshold flips a
    coefficient at it when the transforms round otherwise, so the
    results are held by SNR against the plane waves within
    HARD_SNR_DB, the iterations equal."""
    obs, mask = _inputs()
    want, iters = _jax_solve(obs, mask, dict(BASE_CFG, **BASES[name]), 1)
    got = group[0][f"{name} grid"]
    got = got[0] + 1j * got[1]
    assert np.isfinite(got).all()
    assert abs(_snr(got) - _snr(want)) < HARD_SNR_DB
    np.testing.assert_array_equal(group[0][f"{name} grid iters"], iters)


def test_a_batch_of_the_slice_axis_pads_to_the_grid(group):
    """4 DCT slices on the 4 x 2 mesh (a multiple of its slice axis, not
    of its 8 ranks): padded on with zero slices to the grid and cropped,
    each rank solves one slice, bit-equal to each slice solved alone."""
    got = group[0]["DCT 4"]
    assert got.shape == (2, 4, 64, 64)
    np.testing.assert_array_equal(got, group[0]["DCT 4 alone"])


def test_interpolate_cube_on_a_2d_mesh(group):
    """5 slices at batch 3: the batch rounds up to the 4 slice blocks,
    the tail pads with zero slices, the result is cropped and matches the
    single-device driver."""
    obs, mask = _inputs()
    rec, it, _ = solver.interpolate_cube(obs[:5], mask, _config("fast"),
                                         batch=3, device="cpu")
    got = group[0]["cube"]
    assert got.shape == rec.shape == (5, 64, 64)
    assert np.abs(got - rec).max() <= ONE_PROCESS_TOL * np.abs(rec).max()
    np.testing.assert_array_equal(group[0]["cube iters"], it)


def test_drivers_on_a_2d_mesh(group):
    """``interpolate``, ``interpolate_checkpointed`` (and its resume from
    the first rank's files) and ``warmup`` take the 2-D mesh: the batch
    pads to the slice axis, the barriers and the resume broadcast run over
    the whole grid, and the cube matches the single-device driver's."""
    obs, mask = _inputs()
    rec, _, _ = solver.interpolate_cube(obs[:5], mask, _config("fast"),
                                        batch=3, device="cpu")
    want = np.moveaxis(rec, 0, -1)
    for key in ("interpolate", "checkpointed", "resumed"):
        got = group[0][key]
        assert got.shape == want.shape == (64, 64, 5), key
        assert (np.abs(got - want).max()
                <= ONE_PROCESS_TOL * np.abs(want).max()), key
    np.testing.assert_array_equal(group[0]["resumed"],
                                  group[0]["checkpointed"])
    assert bool(group[0]["warmup ran"])
    # a directional basis: whole slices over the grid, held to the
    # single-device driver within 1e-5 of max, or by SNR (a hard
    # threshold flips where the batch's sums round otherwise)
    shearlet = POCSConfig(**dict(BASE_CFG, **BASES["SHEARLET"]))
    rec, _, _ = solver.interpolate_cube(obs[:5], mask, shearlet, batch=3,
                                        device="cpu")
    want = np.moveaxis(rec, 0, -1)
    got = group[0]["interpolate SHEARLET"]
    assert got.shape == want.shape
    truth = np.moveaxis(np.stack([synthetic_slice(seed=s)
                                  for s in range(5)]), 0, -1)
    assert (np.abs(got - want).max() <= ONE_PROCESS_TOL * np.abs(want).max()
            or abs(_snr_of(truth, got) - _snr_of(truth, want))
            < HARD_SNR_DB)


def test_stage2_on_a_split_2d_mesh_is_the_1d_mesh(group):
    """``interpolate_time_cube_sharded`` on the 4 x 2 mesh runs its three
    stages over the grid: bit-equal to ``make_mesh(8)``."""
    got = group[0]["stage2 soft grid"]
    assert got.shape == (64, 64, 16) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, group[0]["stage2 soft 1-D"])


def test_stage2_on_a_split_2d_mesh_matches_jax(group):
    """The same call against the JAX package's sharded stage 2 on its
    8-device mesh, at ``test_torch_sharding.py``'s tolerance."""
    pytest.importorskip("jax")
    from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
    from pseudo_3d_interpolation_tpu.models.pocs import POCSConfig as JConfig
    from pseudo_3d_interpolation_tpu.parallel import make_mesh as jmake_mesh
    from pseudo_3d_interpolation_tpu.pipeline.stage2 import \
        interpolate_time_cube_sharded as jsharded

    _, mask = _inputs()
    h, w = mask.shape
    cube = JCube(coords={"iline": np.arange(h), "xline": np.arange(w),
                         "twt": TWT},
                 data_vars={"amp": (("iline", "xline", "twt"),
                                    _time_amp(mask)),
                            "fold": (("iline", "xline"),
                                     mask.astype(np.int32))})
    want = np.asarray(jsharded(cube, JConfig(**STAGE2_CFG),
                               mesh=jmake_mesh()).data_vars["amp"][1])
    got = group[0]["stage2 soft grid"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=STAGE2_ATOL * np.abs(want).max(),
                               rtol=STAGE2_RTOL)


@pytest.mark.parametrize("kind", ["FFT", "DCT", "stage2"])
def test_2d_mesh_of_one_space_rank_is_the_1d_path(group, kind):
    """``make_mesh_2d(8, 1)`` splits only slices: the solve (the folded
    kernels' route on FFT, any basis) and stage 2 are the 1-D mesh's, bit
    for bit."""
    np.testing.assert_array_equal(group[0][f"{kind} flat"],
                                  group[0][f"{kind} 1-D"])


def test_mesh_2d_of_one_process_without_a_group():
    mesh = mesh_lib.make_mesh_2d(1, 1, device="cpu")
    assert (mesh.shape, mesh.size, mesh.slice_shards) == ((1, 1), 1, 1)
    assert (mesh.slices.axis_name, mesh.space.axis_name) == ("slices",
                                                             "space")
    assert (mesh.slices.index, mesh.space.index, mesh.index) == (0, 0, 0)
    assert mesh_lib.whole(mesh) is mesh.grid and mesh.grid.size == 1
    with pytest.raises(ValueError, match="needs more than 1 process"):
        mesh_lib.make_mesh_2d(2, 1)
    with pytest.raises(ValueError, match="has no devices"):
        mesh_lib.make_mesh_2d(0, 1)


def test_space_sharded_fft_on_one_process_is_the_fft_basis():
    """The distributed line FFT on a space axis of one: forward is
    ``fft2``, inverse ``ifft2``, ``slice_sum`` the plain sum."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 8, 12)) + 1j * rng.normal(size=(3, 8, 12))
         ).astype(np.complex64)
    t = solver.SpaceShardedFFT(mesh_lib.make_mesh(device="cpu"))
    z = Cplx(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
    f = t.forward(z)
    np.testing.assert_allclose(f.re.numpy() + 1j * f.im.numpy(),
                               np.fft.fft2(x), rtol=1e-5, atol=1e-4)
    back = t.inverse(f)
    np.testing.assert_allclose(back.re.numpy() + 1j * back.im.numpy(), x,
                               atol=1e-5)
    np.testing.assert_allclose(t.slice_sum(z.re).numpy(),
                               x.real.sum(axis=(-2, -1)), rtol=1e-5)
