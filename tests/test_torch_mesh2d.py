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

The drivers above the solve (``interpolate``, ``interpolate_checkpointed``
with its resume, ``warmup``) run on the 4 × 2 mesh; stage 2 raises there;
and a 2-D mesh of one space rank (``make_mesh_2d(8, 1)``) is the 1-D
path bit for bit, FFT, DCT and stage 2.
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

WORKER = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
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
for kind in ("DCT", "SHEARLET"):
    try:
        S.pocs_interpolate_sharded(z, mask, mesh,
                                   config=POCSConfig(transform_kind=kind))
        out[kind] = "no error"
    except NotImplementedError as e:
        out[kind] = str(e)
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
ck = os.path.join(work, "checkpoints")
out["checkpointed"] = P.interpolate_checkpointed(
    cube, cfg, ck, mesh=mesh, batch=3).data_vars["amp_interp"][1]
out["resumed"] = P.interpolate_checkpointed(
    cube, cfg, ck, mesh=mesh, batch=3).data_vars["amp_interp"][1]
out["warmup ran"] = np.array(P.warmup(cfg, (h, w), batch=3, mesh=mesh,
                                      n_slices=5) > 0)

# stage 2 on the split mesh raises
rng = np.random.default_rng(5)
tcube = Cube(coords=dict(grid, twt=np.arange(16.0)),
             data_vars={"amp": (("iline", "xline", "twt"),
                                (rng.normal(size=(h, w, 16)) * mask[..., None]
                                 ).astype(np.float32)),
                        "fold": fold})
try:
    interpolate_time_cube_sharded(tcube, cfg, mesh=mesh)
    out["stage2"] = "no error"
except NotImplementedError as e:
    out["stage2"] = str(e)

# a 2-D mesh of one space rank is the 1-D slice path: every basis, and
# stage 2, as on the 1-D mesh of the same ranks
flat, line = M.make_mesh_2d(world, 1), M.make_mesh(world)
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


def _snr(x) -> float:
    """dB of the plane waves ``_inputs`` observes against their gap to
    ``x``."""
    truth = np.stack([synthetic_slice(seed=s) for s in range(8)])
    return 10 * np.log10(np.sum(np.abs(truth) ** 2)
                         / np.sum(np.abs(truth - x) ** 2))


def _config(name: str) -> POCSConfig:
    return POCSConfig(**dict(BASE_CFG, **VARIANTS[name]))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the worker on the 8 ranks of a 4 x 2 mesh; each rank's
    results."""
    work = tmp_path_factory.mktemp("mesh2d")
    obs, mask = _inputs()
    variants = np.empty((), dtype=object)
    variants[()] = {k: dict(BASE_CFG, **v) for k, v in VARIANTS.items()}
    np.savez(os.path.join(work, "inputs.npz"), obs=obs, mask=mask,
             variants=variants)
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


@pytest.mark.parametrize("kind", ["DCT", "SHEARLET"])
def test_other_bases_raise_on_a_2d_mesh(group, kind):
    msg = str(group[0][kind])
    assert msg.startswith(f"basis {kind!r} on a 2-D mesh")
    assert "ROADMAP" in msg


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


def test_stage2_raises_on_a_split_2d_mesh(group):
    msg = str(group[0]["stage2"])
    assert msg.startswith("stage 2 on a slice x space mesh")
    assert "ROADMAP" in msg


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
