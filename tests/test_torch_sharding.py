"""The 1-D slice mesh over ``torch.distributed`` on gloo groups of 2 and 4
spawned CPU processes: ``parallel/mesh.py``, ``pocs_interpolate_sharded``,
the ``mesh=`` paths of ``interpolate_cube``, ``pipeline.pocs.interpolate``,
``interpolate_checkpointed`` and ``warmup``, and
``pipeline.stage2.interpolate_time_cube_sharded``.

Each group runs one worker script per rank (``WORKER``), which joins the
group on a port the test found free by binding port 0, runs every check of
its task and leaves its results in an npz file; the test waits for the
group with its own timeout, so a hung rank fails its test and nothing
else. Every rank is given the same full input and returns the full
result (the mesh's contract), so rank 0's results stand for all, and each
rank's are checked equal to rank 0's.

Tolerances: the sharded solves solve the same slices with the same
arithmetic as the single-device calls, so they are held bit-equal. The
sharded stage 2 is held to the port's single-device chain (apply_fft ->
interpolate -> apply_ifft) and to the JAX package's
``interpolate_time_cube_sharded`` within the tolerance of the JAX
package's own test (tests/test_stage2_sharded.py): 2e-5·max absolute,
1e-4 relative, at a soft threshold (a hard one flips boundary
coefficients between the two packages' arithmetic).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.pocs import POCSConfig as JConfig
from pseudo_3d_interpolation_tpu.parallel import make_mesh as jmake_mesh
from pseudo_3d_interpolation_tpu.pipeline.preprocess import \
    preprocess as jpreprocess
from pseudo_3d_interpolation_tpu.pipeline.stage2 import \
    interpolate_time_cube_sharded as jsharded
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models.pocs import (POCSConfig,
                                                       pocs_interpolate)
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib
from pseudo_3d_interpolation_torch.parallel import solver
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe
from pseudo_3d_interpolation_torch.pipeline.fft import apply_fft
from pseudo_3d_interpolation_torch.pipeline.ifft import apply_ifft

from test_stage2_sharded import _binned_cube

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
ATOL, RTOL = 2e-5, 1e-4
F, N = 8, 32  # the solve task's batch of slices and their side
SOLVE_CFG = dict(niter=6, p_min=1e-3, version="fast", eps=0.0)
STAGE2_CFG = dict(niter=10, thresh_op="soft", thresh_model="exponential",
                  p_min=1e-3, version="fast", alpha=0.75, eps=0.0)
STAGE2_VARIANTS = {
    "plain": ({}, {}),
    "lowpass drop_filtered": ({}, dict(filter_type="lowpass",
                                       filter_freqs=[1000.0, 1200.0],
                                       drop_filtered=True)),
    "pad_to_tile": ({"pad_to_tile": True}, {}),
    "rescale and clip": ({}, dict(envelope_clip=True,
                                  rescale_minmax=(-1.0, 1.0))),
}

TIMED = "rescale and clip"  # the variant run again with timings={}: every
# collective of stage 2, the all_reduces of the rescale's range included
WORKER = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.parallel import mesh as M
from pseudo_3d_interpolation_torch.parallel import solver as S
from pseudo_3d_interpolation_torch.pipeline import pocs as P
from pseudo_3d_interpolation_torch.pipeline.stage2 import (
    interpolate_time_cube_sharded)

port, rank, world, task, work = sys.argv[1:6]
TIMED = %r
rank, world = int(rank), int(world)
M.initialize_distributed(coordinator=f"127.0.0.1:{port}",
                         num_processes=world, process_id=rank,
                         backend="gloo")
mesh = M.make_mesh()
assert (mesh.size, mesh.index, mesh.device.type) == (world, rank, "cpu")
inputs = np.load(os.path.join(work, "inputs.npz"), allow_pickle=True)
cfg_kw = inputs["cfg"].item()
out = {}


def cube_of(amp, fold, dims, coords):
    return Cube(coords={d: c for d, c in zip(dims, coords)},
                data_vars={"amp": (tuple(dims), amp),
                           "fold": (tuple(dims[:2]), fold)})


if task == "solve":
    obs, mask = inputs["obs"], inputs["mask"]
    z = Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy()))
    for kind in ("FFT", "SHEARLET"):
        cfg = POCSConfig(transform_kind=kind, **cfg_kw)
        res = S.pocs_interpolate_sharded(z, mask, mesh, config=cfg)
        out[kind] = np.stack([res.data.re.numpy(), res.data.im.numpy()])
        out[kind + " iters"] = res.n_iterations.numpy()
        out[kind + " cost"] = res.cost.numpy()
    cfg = POCSConfig(**cfg_kw)
    try:
        S.pocs_interpolate_sharded(Cplx(z.re[:world + 1], z.im[:world + 1]),
                                   mask, mesh, config=cfg)
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    x = torch.arange(2 * world * 3 * 4 * world,
                     dtype=torch.float32).reshape(2 * world, 3, 4 * world)
    blk = M.slice_sharding(mesh, x)
    there = M.reshard_axis(blk, mesh, axis=2, src_axis=0)
    back = M.reshard_axis(there, mesh, axis=0, src_axis=2)
    out["reshard"] = np.array([
        torch.equal(there, x[:, :, M.block(mesh, 4 * world)]),
        torch.equal(back, blk), torch.equal(M.gather(mesh, blk), x)])
    rec, it, cost = S.interpolate_cube(obs[:5], mask, cfg, batch=3,
                                       mesh=mesh)
    out["cube"], out["cube iters"] = rec, it
    cube = cube_of(np.ascontiguousarray(np.moveaxis(obs[:5], 0, -1)),
                   mask.astype(np.int32), ["iline", "xline", "freq"],
                   [np.arange(obs.shape[1]), np.arange(obs.shape[2]),
                    np.arange(5.0)])
    meta = {"metadata": dict(cfg_kw)}
    out["interpolate"] = P.interpolate(
        cube, meta, mesh=mesh, batch=3).data_vars["amp_interp"][1]
    ck = os.path.join(work, "checkpoints")
    out["checkpointed"] = P.interpolate_checkpointed(
        cube, meta, ck, mesh=mesh, batch=3).data_vars["amp_interp"][1]
    # a rerun resumes every batch from the first rank's files
    out["resumed"] = P.interpolate_checkpointed(
        cube, meta, ck, mesh=mesh, batch=3).data_vars["amp_interp"][1]
    out["warmup"] = P.warmup(meta, (24, 20), batch=3, mesh=mesh,
                             n_slices=5)
    # a mesh of the group's first rank: the others are not members
    sub = M.make_mesh(1)
    out["submesh"] = np.array([sub.size, -1 if sub.index is None
                               else sub.index])
else:
    amp, fold = inputs["amp"], inputs["fold"]
    dims = list(inputs["dims"])
    coords = [inputs[f"coord {d}"] for d in dims]
    for name in inputs["variants"]:
        over, kw = inputs[f"variant {name}"].item()
        cfg = POCSConfig(**dict(cfg_kw, **over))
        res = interpolate_time_cube_sharded(cube_of(amp, fold, dims, coords),
                                            cfg, mesh=mesh, batch=4, **kw)
        out[name] = res.data_vars["amp"][1]
        out[name + " iters"] = res.attrs["pocs_mean_iterations"]
        out[name + " twt"] = res.coords["twt"]
        if name == TIMED:
            timings = {}
            res = interpolate_time_cube_sharded(
                cube_of(amp, fold, dims, coords), cfg, mesh=mesh, batch=4,
                timings=timings, **kw)
            out[name + " timed"] = res.data_vars["amp"][1]
            out["timings"] = np.array(json.dumps(timings))
            out["world"] = world
np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
""" % TIMED


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(work, world: int, task: str, **inputs) -> list:
    """Run the worker on ``world`` ranks; returns each rank's results."""
    os.makedirs(work, exist_ok=True)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(port), str(r), str(world), task,
         str(work)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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


def _obj(value) -> np.ndarray:
    """``value`` as a 0-d object array, which np.savez stores whole."""
    arr = np.empty((), dtype=object)
    arr[()] = value
    return arr


def _same_on_every_rank(results):
    for other in results[1:]:
        for k, v in results[0].items():
            # a wall time, the rank, each rank's spans
            if k not in ("warmup", "submesh", "timings"):
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def _solve_inputs():
    rng = np.random.default_rng(0)
    truth = (rng.normal(size=(F, N, N))
             + 1j * rng.normal(size=(F, N, N))).astype(np.complex64)
    mask = (rng.uniform(size=(N, N)) < 0.6).astype(np.float32)
    return (truth * mask).astype(np.complex64), mask


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def solve_group(request, tmp_path_factory):
    obs, mask = _solve_inputs()
    results = _run_group(tmp_path_factory.mktemp("solve"), request.param,
                         "solve", obs=obs, mask=mask,
                         cfg=_obj(SOLVE_CFG))
    return request.param, results


def _z(obs):
    return Cplx(torch.from_numpy(obs.real.copy()),
                torch.from_numpy(obs.imag.copy()))


@pytest.mark.parametrize("kind", ["FFT", "SHEARLET"])
def test_sharded_solve_bit_equal_to_single_device(solve_group, kind):
    _, results = solve_group
    _same_on_every_rank(results)
    obs, mask = _solve_inputs()
    ref = pocs_interpolate(_z(obs), torch.from_numpy(mask),
                           config=POCSConfig(transform_kind=kind,
                                             **SOLVE_CFG))
    got = results[0]
    np.testing.assert_array_equal(got[kind][0], ref.data.re.numpy())
    np.testing.assert_array_equal(got[kind][1], ref.data.im.numpy())
    np.testing.assert_array_equal(got[kind + " iters"],
                                  ref.n_iterations.numpy())
    np.testing.assert_array_equal(got[kind + " cost"], ref.cost.numpy())


def test_indivisible_batch_raises(solve_group):
    _, results = solve_group
    assert "not divisible by mesh size" in str(results[0]["indivisible"])


def test_reshard_axis_round_trips(solve_group):
    _, results = solve_group
    assert results[0]["reshard"].all()


def test_interpolate_cube_pads_to_the_mesh_and_crops(solve_group):
    """5 slices at batch 3: the batch rounds up to the mesh (4 on either
    group), the short tail pads with zero slices to a multiple of the
    mesh, the result is cropped."""
    _, results = solve_group
    obs, mask = _solve_inputs()
    rec, it, _ = solver.interpolate_cube(obs[:5], mask,
                                         POCSConfig(**SOLVE_CFG), batch=3,
                                         device="cpu")
    assert results[0]["cube"].shape == rec.shape == (5, N, N)
    np.testing.assert_array_equal(results[0]["cube"], rec)
    np.testing.assert_array_equal(results[0]["cube iters"], it)


def _single_cube():
    obs, mask = _solve_inputs()
    return Cube(coords={"iline": np.arange(N), "xline": np.arange(N),
                        "freq": np.arange(5.0)},
                data_vars={"amp": (("iline", "xline", "freq"),
                                   np.ascontiguousarray(
                                       np.moveaxis(obs[:5], 0, -1))),
                           "fold": (("iline", "xline"),
                                    mask.astype(np.int32))})


def test_interpolate_with_a_mesh_matches_single_device(solve_group):
    _, results = solve_group
    want = pipe.interpolate(_single_cube(), {"metadata": dict(SOLVE_CFG)},
                            batch=3, device="cpu").data_vars["amp_interp"][1]
    np.testing.assert_array_equal(results[0]["interpolate"], want)


def test_checkpointed_with_a_mesh_matches_and_resumes(solve_group,
                                                      tmp_path):
    _, results = solve_group
    want = pipe.interpolate_checkpointed(
        _single_cube(), {"metadata": dict(SOLVE_CFG)}, str(tmp_path),
        batch=4, device="cpu").data_vars["amp_interp"][1]
    np.testing.assert_array_equal(results[0]["checkpointed"], want)
    np.testing.assert_array_equal(results[0]["resumed"], want)


def test_warmup_with_a_mesh(solve_group):
    _, results = solve_group
    assert float(results[0]["warmup"]) > 0


def test_mesh_of_the_first_ranks(solve_group):
    _, results = solve_group
    assert [r["submesh"].tolist() for r in results] == (
        [[1, 0]] + [[1, -1]] * (len(results) - 1))


def test_mesh_of_one_process_without_a_group():
    mesh = mesh_lib.make_mesh(device="cpu")
    assert (mesh.size, mesh.index, mesh.axis_name) == (1, 0, "slices")
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh_lib.reshard_axis(x, mesh, axis=1) is x
    assert torch.equal(mesh_lib.gather(mesh, x), x)
    assert mesh_lib.pad_to_multiple(5, 4) == 8
    with pytest.raises(ValueError, match="have 1 process"):
        mesh_lib.make_mesh(2)


# --- the sharded stage 2 ----------------------------------------------


@pytest.fixture(scope="module")
def stage2_input(tmp_path_factory):
    """test_stage2_sharded's binned survey, preprocessed by the JAX
    package (rms balance): the time cube both packages take."""
    pp = jpreprocess(_binned_cube(tmp_path_factory.mktemp("survey")),
                     balance="rms")
    dims, amp = pp.data_vars["amp"]
    return (dict(pp.coords), dims, np.asarray(amp, np.float32),
            np.asarray(pp.data_vars["fold"][1]))


def _pad_cube():
    """tests/test_stage2_sharded.py's pad_to_tile grid, cut to 24 ilines
    of 40 xlines."""
    rng = np.random.default_rng(23)
    il, xl, nt = 24, 40, 32
    amp = rng.normal(size=(il, xl, nt)).astype(np.float32)
    fold = (rng.uniform(size=(il, xl)) < 0.6).astype(np.int32)
    amp *= fold[:, :, None]
    coords = {"iline": np.arange(il), "xline": np.arange(xl),
              "twt": np.arange(nt) * 0.25e-3}
    return coords, ("iline", "xline", "twt"), amp, fold


def _variant_input(stage2_input, name):
    return _pad_cube() if name == "pad_to_tile" else stage2_input


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def stage2_group(request, stage2_input, tmp_path_factory):
    coords, dims, amp, fold = stage2_input
    results = {}
    for names in ([n for n in STAGE2_VARIANTS if n != "pad_to_tile"],
                  ["pad_to_tile"]):
        c, d, a, f = _variant_input(stage2_input, names[0])
        inputs = {"amp": a, "fold": f, "dims": np.array(d),
                  "cfg": _obj(STAGE2_CFG),
                  "variants": np.array(names)}
        inputs.update({f"coord {k}": np.asarray(v) for k, v in c.items()})
        inputs.update({f"variant {n}": _obj(STAGE2_VARIANTS[n])
                       for n in names})
        ranks = _run_group(tmp_path_factory.mktemp("stage2"), request.param,
                           "stage2", **inputs)
        _same_on_every_rank(ranks)
        results.update(ranks[0])
    return results


def _time_cube(cls, coords, dims, amp, fold):
    return cls(coords=dict(coords),
               data_vars={"amp": (tuple(dims), amp),
                          "fold": (tuple(dims[:2]), fold)})


@pytest.mark.parametrize("name", sorted(STAGE2_VARIANTS))
def test_stage2_matches_the_single_device_chain(stage2_group, stage2_input,
                                                name):
    over, kw = STAGE2_VARIANTS[name]
    cfg = POCSConfig(**dict(STAGE2_CFG, **over))
    cube = _time_cube(Cube, *_variant_input(stage2_input, name))
    fft_kw = {k: v for k, v in kw.items()
              if k in ("filter_type", "filter_freqs", "drop_filtered")}
    ifft_kw = {k: v for k, v in kw.items()
               if k in ("envelope_clip", "rescale_minmax")}
    freq = apply_fft(cube, device="cpu", **fft_kw)
    interp = pipe.interpolate(freq, cfg, batch=4, device="cpu")
    back = apply_ifft(interp, var="freq_amp_interp", device="cpu",
                      **ifft_kw)
    want = back.data_vars["amp"][1]
    got = stage2_group[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max(),
                               rtol=RTOL)
    assert (stage2_group[name + " iters"]
            == interp.attrs["pocs_mean_iterations"])
    np.testing.assert_array_equal(stage2_group[name + " twt"],
                                  back.coords["twt"])


def test_stage2_spans_on_the_ranks(stage2_group, stage2_input):
    """Rank 0's spans of the timed cube: the output bit-equal to the
    untimed cube's, each collective's bytes counted from the shapes, the
    copies' bytes, one batch span a launch, and no build span, the
    process group being joined and connected before the cube."""
    _, _, amp, fold = stage2_input
    world = int(stage2_group["world"])
    np.testing.assert_array_equal(stage2_group[TIMED + " timed"],
                                  stage2_group[TIMED])
    timings = json.loads(str(stage2_group["timings"]))
    spans = timings["spans"]
    il, xl, nt = amp.shape
    n = nt - nt % 2
    f = n // 2 + 1
    f_pad, il_pad = -(-f // world) * world, -(-il // world) * world
    f_rank, il_rank = f_pad // world, il_pad // world
    want = [("mesh.all_to_all", f_pad * il_rank * xl * 4)] * 2 + [
        ("mesh.broadcast", il * xl * 4),
        ("mesh.all_gather", f_rank * 4), ("mesh.all_gather", f_rank * 4),
    ] + [("mesh.all_to_all", il_pad * f_rank * xl * 4)] * 2 + [
        ("mesh.all_reduce", 4), ("mesh.all_reduce", 4),
        ("mesh.all_gather", il_rank * xl * n * 4)]
    assert [(s["name"], s["attrs"]["bytes"]) for s in spans
            if s["name"].startswith("mesh.")] == want
    assert [s["attrs"]["bytes"] for s in spans
            if s["name"] == "stage2.h2d"] == [il_rank * xl * n * 4,
                                              il * xl * 4]
    assert [s["attrs"]["bytes"] for s in spans
            if s["name"] == "stage2.d2h"] == [il_pad * xl * n * 4]
    batches = [s["attrs"]["slices"] for s in spans
               if s["name"] == "solver.batch"]
    assert len(batches) == -(-f_rank // 4) and sum(batches) == f_rank
    assert not [s for s in spans if s["build"]]
    assert timings["process"]["mesh.init"]["count"] == 1
    assert timings["process"]["mesh.connect"]["count"] == 1
    assert all(s["device_s"] is None for s in spans)


@pytest.mark.parametrize("name", sorted(STAGE2_VARIANTS))
def test_stage2_matches_the_jax_package(stage2_group, stage2_input, name):
    over, kw = STAGE2_VARIANTS[name]
    cube = _time_cube(JCube, *_variant_input(stage2_input, name))
    want = jsharded(cube, JConfig(**dict(STAGE2_CFG, **over)),
                    mesh=jmake_mesh(), **kw).data_vars["amp"][1]
    want = np.asarray(want)
    got = stage2_group[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max(),
                               rtol=RTOL)
