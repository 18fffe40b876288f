"""The check that decides ``correct`` at a tiny size on the CPU: a sound
run passes it, each fault a cell can have fails it, and the control reads
far above sound runs.

The runs skip the harness's look for a card and drive the rest of a run
(set-up, window, check, result line) with the committed limits. The
faults, planted under the timed path: a solve that returns its state
unchanged; half of each batch left unsolved; one slot of every batch
left unsolved; one whole batch left unsolved; the exchange between ranks
left out (each rank keeps only its own block of every all_to_all, on
four gloo processes); an answer altered where it is produced (one iline
of the output zeroed)."""

from __future__ import annotations

import json
import socket
import sys
import time

import pytest
import torch
import torch.multiprocessing as mp

import bench_tiny
from p3d_bench import harness

SEED = 2**31 + 99


def _run(cell, capsys) -> dict:
    rc = harness.run_rank(cell, SEED, 0.01, False, time.time(),
                          harness.Ranks(), torch.device("cpu"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["shearlet_cube_1chip",
                                  "fft_eps_cube_1chip"])
def test_sound_run_is_correct(name, capsys):
    cell = bench_tiny.tiny_cell(name)
    out = _run(cell, capsys)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {cell.time_metric, "snr_db", "setup_s"}


@pytest.mark.parametrize("name", ["shearlet_cube_1chip",
                                  "fft_eps_cube_1chip"])
def test_control_reads_far_above_sound_runs(name):
    """The control (the reference in TF32 in the program's place) at the
    tiny size, on three seeds: on one of the cell's compared numbers its
    least reading is three times the sound program's largest or more.
    Its readings at the cell's own size, and the limits set from them,
    are in PERF.md."""
    cell = bench_tiny.tiny_cell(name)
    sound, control = {}, {}
    for seed in (1, 2, 3):
        inputs = harness.make_inputs(cell.config, seed, "cpu")
        mesh = harness.make_mesh(harness.Ranks(), "cpu")
        res, _ = harness.cube_runner(cell.config, inputs, mesh)()
        got = harness.check_numbers(cell.config, cell.check, inputs,
                                    res.data_vars["amp"][1], seed, "cpu")
        ctl = harness.check_numbers(cell.config, cell.check, inputs, None,
                                    seed, "cpu", control=True)
        for key in cell.check["limits"]:
            sound.setdefault(key, []).append(got[key])
            control.setdefault(key, []).append(ctl[key])
    assert any(min(control[k]) >= 3 * max(sound[k]) for k in sound), (
        sound, control)


@pytest.mark.parametrize("name", ["shearlet_cube_1chip",
                                  "fft_eps_cube_1chip"])
def test_control_is_not_correct(name):
    """The control judged by the harness's own check against the cell's
    committed limits, at the tiny size with the cell's own iterations,
    on three seeds: never correct."""
    cell = bench_tiny.tiny_cell(name)
    cell = cell._replace(config=dict(cell.config,
                                     niter=harness.load_cell(name)
                                     .config["niter"]))
    for seed in (1, 2, 3):
        inputs = harness.make_inputs(cell.config, seed, "cpu")
        correct, checks, _ = harness.check(cell, inputs, None, seed, "cpu",
                                           control=True)
        assert correct is False, (seed, checks)


def _unchanged(z, mask, transform=None, config=None):
    from pseudo_3d_interpolation_torch.models.pocs import POCSResult

    b = z.shape[0]
    return POCSResult(z, torch.zeros(b, dtype=torch.int32),
                      torch.zeros(b), None)


def _half_batch(solve):
    def run(z, mask, transform=None, config=None):
        from pseudo_3d_interpolation_torch.ops.cplx import Cplx

        res = solve(z, mask, transform, config)
        k = z.shape[0] // 2
        re, im = res.data.re.clone(), res.data.im.clone()
        re[k:], im[k:] = z.re[k:], z.im[k:]
        return res._replace(data=Cplx(re, im))
    return run


def _one_slot(solve, slot=1):
    def run(z, mask, transform=None, config=None):
        from pseudo_3d_interpolation_torch.ops.cplx import Cplx

        res = solve(z, mask, transform, config)
        if z.shape[0] <= slot:
            return res
        re, im = res.data.re.clone(), res.data.im.clone()
        re[slot], im[slot] = z.re[slot], z.im[slot]
        return res._replace(data=Cplx(re, im))
    return run


def _one_batch(solve, which=1):
    """Batch ``which`` of every cube's solve (the warm-up's too) left
    unsolved; one rank solves a cube in ``per_cube`` batches."""
    per_cube = -(-bench_tiny.SLICES // bench_tiny.BATCH)
    calls = []

    def run(z, mask, transform=None, config=None):
        calls.append(None)
        if (len(calls) - 1) % per_cube == which:
            return _unchanged(z, mask)
        return solve(z, mask, transform, config)
    return run


def _altered(inverse):
    def run(spec):
        twt, x = inverse(spec)
        x = x.clone()
        x[0] = 0.0
        return twt, x
    return run


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "one_slot",
                                   "one_batch", "altered"])
@pytest.mark.parametrize("name", ["shearlet_cube_1chip",
                                  "fft_eps_cube_1chip"])
def test_fault_is_not_correct(name, fault, monkeypatch, capsys):
    from pseudo_3d_interpolation_torch.pipeline import stage2

    if fault == "unchanged":
        monkeypatch.setattr(stage2, "pocs_interpolate", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(stage2, "pocs_interpolate",
                            _half_batch(stage2.pocs_interpolate))
    elif fault == "one_slot":
        monkeypatch.setattr(stage2, "pocs_interpolate",
                            _one_slot(stage2.pocs_interpolate))
    elif fault == "one_batch":
        monkeypatch.setattr(stage2, "pocs_interpolate",
                            _one_batch(stage2.pocs_interpolate))
    else:
        monkeypatch.setattr(stage2.spectral, "inverse_fft_original",
                            _altered(stage2.spectral.inverse_fft_original))
    out = _run(bench_tiny.tiny_cell(name), capsys)
    assert out["correct"] is False, out["checks"]


def _rank(rank, world, port, path, fault):
    sys.path.insert(0, str(bench_tiny.ROOT / "p3d_bench" / "tests"))
    import contextlib
    import io

    import torch.distributed as dist

    import bench_tiny as bt
    from p3d_bench import harness as h

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    if fault:
        def alone(out, inp, group=None, **kw):
            out.zero_()
            out[rank] = inp[rank]
        dist.all_to_all_single = alone
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = h.run_rank(bt.tiny_cell("shearlet_cube_4chip", world), SEED,
                        0.01, False, time.time(),
                        h.Ranks(rank, world, "cpu"), torch.device("cpu"))
    if rank == 0:
        with open(path, "w") as fh:
            fh.write(f"{rc}\n{buf.getvalue()}")


@pytest.mark.parametrize("fault", [False, True])
def test_mesh_exchange_left_out_is_not_correct(fault, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = tmp_path / "rank0.txt"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, 4, port, str(path), fault))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)
    rc, *lines = path.read_text().strip().splitlines()
    assert rc == "0"
    out = json.loads(lines[-1])
    assert out["correct"] is (not fault), out["checks"]
    assert out["device"]["count"] == 4
