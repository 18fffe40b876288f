"""The frozen work count of ``p3d_bench/work.py``, pinned to numbers
worked by hand."""

from __future__ import annotations

import ast
import json
import math

import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts the repo on the path)
from p3d_bench import work
from p3d_bench.reference import shearlet as sh


def test_line_counts_by_hand():
    assert work.line_flops(512) == 5 * 512 * 9 == 23040
    assert work.real_line_flops(1024) == 2.5 * 1024 * 10 == 25600
    # 512 lines of 512 each way
    assert work.fft2_flops(512, 512) == 2 * 512 * 23040 == 23592960


def test_fft_iteration_of_a_512_batch_of_32():
    # a forward and an inverse 2-D FFT a slice: 1.51 GFLOP for 32 slices
    per_iter = 2 * work.forward_flops("FFT", 512, 512) * 32
    assert per_iter == 2 * 23592960 * 32 == 1509949440


def test_fft_solve_stage_by_hand():
    cfg = {"shape": [512, 512, 1024], "niter": 50, "basis": "FFT"}
    got = work.solve_work(cfg)
    rfft = 2 * 512 * 512 * 25600  # rfft and irfft of every trace
    slices = 513 * (2 * 50 + 1) * 23592960  # decay + 50 iterations
    assert got["flops"] == rfft + slices == 1235843809280
    assert got["bytes"] == 2 * 512 * 512 * 1024 * 4 + 512 * 512 * 4
    assert got["bound_by"] == "operations"
    assert got["bound_s"] == pytest.approx(got["flops"] / 67e12)


def test_shearlet_count_is_the_sum_of_its_support_lines():
    h = w = 512
    psi = sh.shearlet_spectra(h, w)
    assert psi.shape[0] == 61  # 1 + 4 + 8 + 16 + 32 bands at 512**2
    lines = []
    for band in psi:
        nz = band != 0
        rows, cols = int(nz.any(axis=1).sum()), int(nz.any(axis=0).sum())
        # the cheaper order: support rows along W then every column along
        # H, or support columns along H then every row along W
        lines.append(min(rows * 23040 + w * 23040, cols * 23040 + h * 23040))
    per_transform = 23592960 + sum(lines)
    assert work.forward_flops("SHEARLET", h, w) == per_transform
    # the 32 finest bands dominate; the lowpass lives on a few lines
    assert min(lines) < 600 * 23040 < max(lines) <= 1024 * 23040
    # a 512**2 batch of 32, one iteration (forward and inverse)
    assert 2 * per_transform * 32 == pytest.approx(63.478e9, rel=1e-4)
    cfg = {"shape": [512, 512, 1024], "niter": 50, "basis": "SHEARLET"}
    got = work.solve_work(cfg)
    assert got["flops"] == 2 * 512 * 512 * 25600 + 513 * 101 * per_transform
    assert got["bytes"] == (2 * 512 * 512 * 1024 * 4 + 512 * 512 * 4
                            + 61 * 512 * 512 * 4)
    assert got["bound_s"] == pytest.approx(0.76723, rel=1e-4)


@pytest.mark.parametrize("name,flops,nbytes,bound_s", [
    ("northstar_shearlet", 51404091937280.0, 2212495360, 0.7672252527952239),
    ("northstar_fft_eps", 1235843809280.0, 2148532224, 0.01844542998925373),
])
def test_committed_configs_count_as_pinned(name, flops, nbytes, bound_s):
    """The committed configurations, read from their files, to the last
    digit: the count a basis's module gives is the one the benchmark's
    readings were taken with."""
    cfg = json.loads((bench_tiny.ROOT / "p3d_bench" / "configs"
                      / f"{name}.json").read_text())
    assert work.solve_work(cfg) == {"flops": flops, "bytes": nbytes,
                                    "bound_s": bound_s,
                                    "bound_by": "operations"}


def test_shape_keys_reach_the_count():
    cfg = {"shape": [64, 64, 32], "niter": 3, "basis": "SHEARLET"}
    default = dict(cfg, transform={"n_scales": sh.default_scales(64, 64)})
    fewer = dict(cfg, transform={"n_scales": 1})
    assert work.solve_work(default) == work.solve_work(cfg)
    assert work.window_bytes("SHEARLET", 64, 64, n_scales=1) == 5 * 64 * 64 * 4
    assert work.solve_work(fewer)["flops"] < work.solve_work(cfg)["flops"]
    assert work.solve_work(fewer)["bytes"] < work.solve_work(cfg)["bytes"]


def test_unknown_basis_has_no_count():
    """A name no basis module will have: the count is refused, not 0."""
    with pytest.raises(ValueError, match="no_such_basis.py"):
        work.forward_flops("NO_SUCH_BASIS", 64, 64)
    with pytest.raises(ValueError, match="no_such_basis.py"):
        work.window_bytes("NO_SUCH_BASIS", 64, 64)


def test_the_count_takes_nothing_from_the_program():
    path = bench_tiny.ROOT / "p3d_bench" / "work.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(("." * node.level) + (node.module or ""))
    assert not any(n.split(".")[0].startswith("pseudo_3d_interpolation")
                   for n in names)
    assert all("roofline" not in n for n in names)
    assert math.isclose(work.FP32_FLOPS, 67e12)
    assert math.isclose(work.HBM_BYTES_PER_S, 3.35e12)
    assert np.isfinite(work.solve_work(
        {"shape": [64, 64, 32], "niter": 3, "basis": "SHEARLET"})["flops"])
