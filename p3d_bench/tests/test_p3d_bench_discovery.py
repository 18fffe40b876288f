"""A configuration, a cell and a per-layer metric are found from files
added to a copy of ``p3d_bench/`` with no other edit; without a CUDA card
the command exits non-zero, names the missing card and prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import bench_tiny

ROOT = bench_tiny.ROOT


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
