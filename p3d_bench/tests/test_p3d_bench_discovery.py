"""A configuration, a cell, a per-layer metric and a basis are found from
files added to a copy of ``p3d_bench/`` with no other edit; a basis the
harness cannot take is refused by name; without a CUDA card the command
exits non-zero, names the missing card and prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

import bench_tiny

ROOT = bench_tiny.ROOT

# a toy basis module, written over any of its name in the copy: the
# orthonormal 2-D DCT-II in float64, on blocks of ``block`` x ``block``
# (absent: the whole slice), one threshold a slice; ``box_precision``
# stands for a key that only chooses the program's arithmetic
DCT_MODULE = textwrap.dedent("""
    import torch

    from ... import work
    from ..pocs import exponential_schedule, fixed_p_min

    KEYS = {"shape": ("block",), "program": ("box_precision",)}


    def _sides(h, w, block):
        return (block, block) if block else (h, w)


    def _dct(n, device):
        k = torch.arange(n, dtype=torch.float64, device=device)
        c = torch.cos(torch.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
        c = c * (2.0 / n) ** 0.5
        c[0] /= 2.0 ** 0.5
        return c


    class Basis:
        def __init__(self, h, w, tr, device, block=None):
            self.tr, self.block = tr, block
            self.sides = _sides(h, w, block)
            self.c = [_dct(n, device) for n in self.sides]

        def _apply(self, x, ch, cw):
            b, h, w = x.shape
            bh, bw = self.sides
            y = x.to(torch.complex128).reshape(b, h // bh, bh, w // bw, bw)
            y = torch.einsum("ij,bpjqk,lk->bpiql", ch.to(y.dtype), y,
                             cw.to(y.dtype))
            return y.reshape(b, h, w)

        def forward(self, x):
            return self._apply(x, *self.c)

        def inverse(self, c):
            return self._apply(c, self.c[0].T, self.c[1].T)

        def decay(self, z, config):
            mag = self.forward(z).abs()
            amax = mag.amax(dim=(-2, -1))
            p_min = fixed_p_min(config)
            tau_min = (0.01 * torch.sqrt((mag * mag).mean(dim=(-2, -1)))
                       if p_min is None else p_min * amax)
            return exponential_schedule(config["p_max"] * amax, tau_min,
                                        config["niter"])

        def shrink(self, x, tau):
            c = self.forward(x)
            c = torch.where(c.abs() < tau[:, None, None], 0, c)
            return self.inverse(c).to(x.dtype)


    def forward_flops(h, w, block=None):
        bh, bw = _sides(h, w, block)
        return 4.0 * h * w * (bh + bw)  # a real matrix on re and im


    def window_bytes(h, w, block=None):
        bh, bw = _sides(h, w, block)
        return 8 * (bh * bh + bw * bw)
""")


def _copy(tmp_path):
    dst = tmp_path / "p3d_bench"
    shutil.copytree(ROOT / "p3d_bench", dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def test_new_files_add_a_config_a_cell_and_a_metric(tmp_path):
    bench = _copy(tmp_path)
    cfg = json.loads((bench / "configs" / "northstar_shearlet.json")
                     .read_text())
    cfg.update(name="wide_shearlet", shape=[1024, 1024, 512])
    (bench / "configs" / "wide_shearlet.json").write_text(json.dumps(cfg))
    (bench / "workloads" / "wide_cube_1chip.json").write_text(json.dumps({
        "name": "wide_cube_1chip", "config": "wide_shearlet",
        "traffic": "one_client", "chips": 1, "time_metric": "cube_s.wide",
        "check": {"sample_slices": 16,
                  "limits": {"slice_rel_l2_p75": 1e-3}}}))
    (bench / "metrics" / "solver.slices.py").write_text(textwrap.dedent("""
        def read(ctx):
            return ctx["config"]["shape"][2] // 2 + 1, "slices"
    """))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(tmp_path)!r})
        from p3d_bench import harness
        assert harness.BENCH == __import__("pathlib").Path(
            {str(bench)!r}).resolve(), harness.BENCH
        cell = harness.load_cell("wide_cube_1chip")
        assert cell.config["shape"] == [1024, 1024, 512]
        readers = harness.metric_readers()
        assert "solver.slices" in readers
        assert "kernels.solve_roofline" in readers
        assert harness.layer_name("solver.slices", cell) == (
            "solver.wide.slices")
        print(readers["solver.slices"]({{"config": cell.config}}))
    """)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip() == "(257, 'slices')"


def _add_config(bench, name, **changes):
    cfg = json.loads((bench / "configs" / "northstar_fft_eps.json")
                     .read_text())
    cfg.update(name=name, **changes)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "workloads" / f"{name}_1chip.json").write_text(json.dumps({
        "name": f"{name}_1chip", "config": name, "traffic": "one_client",
        "chips": 1, "time_metric": "cube_s",
        "check": {"sample_slices": 16, "limits": {"slice_rel_l2_p75": 1e-3}}}))


def _in_copy(tmp_path, bench, body: str):
    """Run ``body`` with the copy's ``p3d_bench`` (and this repository's
    port)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(tmp_path)!r})
        sys.path.append({str(ROOT)!r})
        from p3d_bench import harness
        assert harness.BENCH == __import__("pathlib").Path(
            {str(bench)!r}).resolve(), harness.BENCH
    """) + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)


def test_new_files_add_a_basis(tmp_path):
    """A basis joins from its module (a toy DCT), a configuration that
    gives it transform keys, and a cell: the cell loads, the reference
    builds and solves it with its shape key, the work count takes that
    key, neither sees the program key, and stage 2 receives both keys
    with ``precision``."""
    bench = _copy(tmp_path)
    (bench / "reference" / "bases" / "dct.py").write_text(DCT_MODULE)
    _add_config(bench, "northstar_dct", basis="DCT", eps=0.0,
                transform={"block": 8, "box_precision": "highest"})
    got = _in_copy(tmp_path, bench, """
        import torch
        from p3d_bench import work
        from p3d_bench.reference import bases as ref_bases
        from p3d_bench.reference import pocs as ref_pocs
        from pseudo_3d_interpolation_torch.pipeline import stage2

        cell = harness.load_cell("northstar_dct_1chip")
        cfg = dict(cell.config, niter=5)
        assert cfg["transform"] == {"block": 8, "box_precision": "highest"}
        # the toy's Basis, forward_flops and window_bytes take no
        # box_precision: a call that passed it would raise
        assert ref_bases.shape_keys(cfg) == {"block": 8}
        shape_only = dict(cfg, transform={"block": 8})
        assert work.solve_work(cfg) == work.solve_work(shape_only)
        tr = ref_pocs.Transforms("float64")
        basis = ref_pocs.basis_for(cfg, 32, 32, tr, "cpu")
        assert basis.block == 8 and basis.sides == (8, 8)
        g = torch.Generator().manual_seed(5)
        z = torch.randn(3, 32, 32, dtype=torch.complex128, generator=g)
        assert torch.allclose(basis.inverse(basis.forward(z)), z)
        mask = (torch.rand(32, 32, generator=g) < 0.5).to(torch.float64)
        out, iters = ref_pocs.solve_slices(z * mask, mask, cfg, "float64")
        assert torch.isfinite(out).all() and iters.tolist() == [5, 5, 5]
        h, w, t = cfg["shape"]
        assert work.solve_work(cfg)["flops"] == (
            2 * h * w * work.real_line_flops(t)
            + (t // 2 + 1) * (2 * 5 + 1) * 4.0 * h * w * 16)
        assert work.solve_work(cfg)["bytes"] == (
            2 * h * w * t * 4 + h * w * 4 + 8 * 128)
        seen = {}

        def entry(cube, config, **kw):
            seen.update(kw, kind=config.transform_kind)
            return "result"
        stage2.interpolate_time_cube_sharded = entry
        inputs = harness.Inputs(None, None, None, "cube")
        res, _ = harness.cube_runner(cfg, inputs, "mesh")()
        assert res == "result" and seen["kind"] == "DCT"
        print(sorted(seen["transform_kwargs"].items()))
    """)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip() == ("[('block', 8), ('box_precision', "
                                  "'highest'), ('precision', 'highest')]")


@pytest.mark.parametrize("case", ["undeclared_key", "no_module",
                                  "missing_part"])
def test_a_basis_the_harness_cannot_take_is_refused(case, tmp_path):
    """Refused by ``load_cell``, before any card work, naming the file."""
    bench = _copy(tmp_path)
    bases = bench / "reference" / "bases"
    if case == "undeclared_key":
        (bases / "dct.py").write_text(DCT_MODULE)
        _add_config(bench, "odd", basis="DCT",
                    transform={"block": 8, "nbscales": 4})
        named = ["p3d_bench/configs/odd.json", "'nbscales'"]
    elif case == "no_module":
        _add_config(bench, "odd", basis="RIDGELET")
        named = ["p3d_bench/configs/odd.json",
                 "p3d_bench/reference/bases/ridgelet.py"]
    else:
        (bases / "dct.py").write_text(
            DCT_MODULE.split("def window_bytes")[0])
        _add_config(bench, "odd", basis="DCT")
        named = ["p3d_bench/reference/bases/dct.py", "window_bytes"]
    got = _in_copy(tmp_path, bench, """
        try:
            harness.load_cell("odd_1chip")
        except harness.BenchError as exc:
            print(exc)
        else:
            raise SystemExit("load_cell took the cell")
    """)
    assert got.returncode == 0, got.stderr[-3000:]
    assert all(n in got.stdout for n in named), got.stdout


def test_no_card_no_result(tmp_path):
    for cell in ("shearlet_cube_1chip", "shearlet_cube_4chip"):
        got = subprocess.run(
            [sys.executable, "p3d_bench/run.py", "--workload", cell,
             "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                 "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
        assert got.returncode != 0
        assert "no CUDA card" in got.stderr
        assert got.stdout == ""


def test_unknown_cell_is_refused():
    got = subprocess.run(
        [sys.executable, "p3d_bench/run.py", "--workload", "no_such_cell",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert got.returncode != 0 and got.stdout == ""
    assert "no_such_cell" in got.stderr
