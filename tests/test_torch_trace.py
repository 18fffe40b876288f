"""The span recorder of ``utils/timing.py`` on stage 2, on the CPU.

``interpolate_time_cube_sharded(timings={})`` records one span a step of
the cube (host in, the three laps and their children, host out), each
inside its parent, with the batch's slices and the copies' bytes; the
walls keep their meaning, the dict stays JSON, and the output is the same
bit for bit with or without ``timings``. A cube whose plans are built
already records no build span. Under ``torch.profiler`` every span is a
user annotation. The per-layer metrics of ``p3d_bench/metrics/`` that
read the spans give None where the spans have no device seconds (here)
and the right value on a hand-made context. The same on a mesh of gloo
ranks: ``tests/test_torch_sharding.py``."""

import json
import math

import numpy as np
import pytest
import torch

from p3d_bench import harness
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib
from pseudo_3d_interpolation_torch.pipeline.stage2 import (
    interpolate_time_cube_sharded)
from pseudo_3d_interpolation_torch.utils import timing

torch.set_num_threads(2)

BATCH = 4
NITER = 3
LAPS = ("stage2.upload", "stage2.solve", "stage2.download")
TOP = ("stage2.host_in",) + LAPS + ("stage2.host_out",)
CHILDREN = {"stage2.upload": ["stage2.h2d"],
            "stage2.solve": ["stage2.rfft", "stage2.h2d", "solver.batch",
                             "stage2.stats", "stage2.irfft"],
            "stage2.download": ["stage2.d2h"]}
NEW_METRICS = ("stage2.h2d_gbps", "stage2.d2h_gbps", "solver.pocs_s",
               "mesh.collective_s", "mesh.collective_gb", "setup.build_s")


def time_cube(il=16, xl=12, nt=33, seed=0) -> Cube:
    """A seeded (il, xl, nt) time cube, 60% of its traces kept; an odd
    nt, which stage 2 cuts to even."""
    rng = np.random.default_rng(seed)
    amp = rng.normal(size=(il, xl, nt)).astype(np.float32)
    fold = (rng.uniform(size=(il, xl)) < 0.6).astype(np.int32)
    amp *= fold[:, :, None]
    return Cube(coords={"iline": np.arange(il), "xline": np.arange(xl),
                        "twt": np.arange(nt) * 0.25e-3},
                data_vars={"amp": (("iline", "xline", "twt"), amp),
                           "fold": (("iline", "xline"), fold)})


def run(cube, kind="FFT", timings=None):
    cfg = POCSConfig(niter=NITER, transform_kind=kind, p_min=1e-3,
                     version="fast")
    out = interpolate_time_cube_sharded(
        cube, cfg, mesh=mesh_lib.make_mesh(device="cpu"), batch=BATCH,
        timings=timings)
    return out.data_vars["amp"][1]


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


@pytest.fixture(scope="module", params=["FFT", "SHEARLET"])
def traced(request):
    """(kind, cube, output without timings, timings of a cube run after a
    first one, its output)."""
    cube = time_cube()
    plain = run(cube, request.param)
    timings = {}
    got = run(cube, request.param, timings)
    return request.param, cube, plain, timings, got


def test_output_bit_equal_with_and_without_timings(traced):
    _, _, plain, _, got = traced
    np.testing.assert_array_equal(got, plain)


def test_span_tree_each_child_inside_its_parent(traced):
    spans = traced[3]["spans"]
    assert [s["name"] for s in spans if s["parent"] is None] == list(TOP)
    ids = {s["id"]: s for s in spans}
    assert [s["id"] for s in spans] == list(range(len(spans)))
    for name, children in CHILDREN.items():
        (lap,) = by_name(spans, name)
        under = [s["name"] for s in spans if s["parent"] == lap["id"]]
        assert sorted(set(under)) == sorted(set(children)), name
    for s in spans:
        assert s["host_start_s"] <= s["host_end_s"]
        if s["parent"] is not None:
            p = ids[s["parent"]]
            assert p["host_start_s"] <= s["host_start_s"]
            assert s["host_end_s"] <= p["host_end_s"]
    tops = [by_name(spans, n)[0] for n in TOP]
    for a, b in zip(tops, tops[1:]):
        assert a["host_end_s"] <= b["host_start_s"]


def test_one_batch_span_a_launch(traced):
    spans = traced[3]["spans"]
    f = 32 // 2 + 1  # 33 samples cut to 32: 17 rfft bins
    batches = by_name(spans, "solver.batch")
    assert len(batches) == math.ceil(f / BATCH)
    assert [s["attrs"]["slices"] for s in batches] == [4, 4, 4, 4, 1]
    assert [s["attrs"]["batch"] for s in batches] == list(range(5))


def test_copies_count_the_arrays_bytes(traced):
    spans = traced[3]["spans"]
    il, xl, n = 16, 12, 32
    up, mask = by_name(spans, "stage2.h2d")
    assert up["attrs"] == {"bytes": il * xl * n * 4, "pinned": False}
    assert mask["attrs"] == {"bytes": il * xl * 4, "pinned": False}
    (down,) = by_name(spans, "stage2.d2h")
    assert down["attrs"] == {"bytes": il * xl * n * 4}
    assert traced[4].nbytes == il * xl * n * 4


def test_one_rank_records_no_collective_and_no_device_seconds(traced):
    spans = traced[3]["spans"]
    assert not [s for s in spans if s["name"].startswith("mesh.")]
    assert all(s["device_s"] is None for s in spans)


def test_walls_keep_their_meaning_and_the_dict_is_json(traced):
    timings = traced[3]
    spans = timings["spans"]
    for lap, key in zip(LAPS, ("upload", "solve", "download")):
        (s,) = by_name(spans, lap)
        assert timings[key] == s["host_end_s"] - s["host_start_s"]
        assert timings[key] >= 0.0
    assert json.loads(json.dumps(timings)) == timings


def test_a_second_cube_records_no_build_span(traced):
    spans = traced[3]["spans"]
    assert not [s for s in spans if s["build"]]
    assert not [s for s in spans if s["name"] in (
        "kernels.build", "kernels.load", "mesh.init", "mesh.connect",
        "transform.plan")]


def test_shearlet_plans_are_counted_once_per_shape():
    sh.shearlet_plan.cache_clear()
    sh.shearlet_spectra.cache_clear()

    def plans(t):
        return [s for s in by_name(t["spans"], "transform.plan")
                if s["attrs"]["what"] == "shearlet_plan"]

    def counted(t):
        return t["process"]["transform.plan"]["count"]

    first, again, other = {}, {}, {}
    before = timing.BUILDS.snapshot().get("transform.plan", {"count": 0})
    run(time_cube(), "SHEARLET", first)
    run(time_cube(), "SHEARLET", again)
    run(time_cube(il=20, xl=16), "SHEARLET", other)
    assert len(plans(first)) == 1 and len(plans(other)) == 1
    assert not [s for s in again["spans"] if s["build"]]
    # the spectra are built inside the plan: one build with it
    builds = [s for s in first["spans"] if s["name"] == "transform.plan"]
    nested = {s["id"] for s in builds}
    outer = [s for s in builds if s["parent"] not in nested]
    assert len(outer) < len(builds)
    assert counted(first) == before["count"] + len(outer)
    assert counted(again) == counted(first)
    assert counted(other) > counted(again)
    assert other["process"]["transform.plan"]["host_s"] > 0.0


def test_build_registry_counts_nested_builds_with_their_own_name():
    before = timing.BUILDS.snapshot()
    with timing.build_span("test.outer"):
        with timing.build_span("test.inner"):
            with timing.build_span("test.outer"):
                pass
        with timing.build_span("test.inner"):
            pass
    got = timing.BUILDS.snapshot()
    assert before.get("test.outer") is None
    assert got["test.outer"]["count"] == 1
    assert got["test.inner"]["count"] == 2
    assert all(v["host_s"] >= 0.0 for v in got.values())


def test_spans_without_a_cube_record_nothing():
    with timing.span("test.loose", bytes=1):
        pass
    with timing.cube(None, "cpu") as laps:
        with laps.lap("test.lap", "lap"):
            pass
    assert timing._CUBE.get() is None


def test_every_span_is_a_profiler_user_annotation(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(time_cube(), "FFT", timings)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    names = {s["name"] for s in timings["spans"]}
    assert set(TOP) <= names
    assert names <= annotated, names - annotated


# --- the per-layer metrics that read the spans ------------------------------

def _span(i, name, device_s, parent=None, build=False, **attrs):
    return {"id": i, "parent": parent, "name": name, "build": build,
            "host_start_s": 0.0, "host_end_s": 1.0, "device_s": device_s,
            "attrs": attrs}


def _card_cube(scale=1.0):
    """A hand-made cube of two ranks' spans as a card records them."""
    return {"upload": 0.3, "solve": 2.0, "download": 0.6, "cube": 3.0,
            "spans": [
                _span(0, "stage2.upload", 0.3),
                _span(1, "stage2.h2d", 0.2 * scale, 0, bytes=10**9,
                      pinned=False),
                _span(2, "stage2.solve", 2.0),
                _span(3, "mesh.all_to_all", 0.05 * scale, 2,
                      bytes=2 * 10**8),
                _span(4, "mesh.connect", 0.04, 3, build=True),
                _span(5, "stage2.h2d", 0.001 * scale, 2, bytes=10**6,
                      pinned=False),
                _span(6, "mesh.broadcast", 0.001 * scale, 2, bytes=10**6),
                _span(7, "solver.batch", 0.9 * scale, 2, slices=32,
                      batch=0),
                _span(8, "solver.batch", 0.1 * scale, 2, slices=1,
                      batch=1),
                _span(9, "transform.plan", None, 8, build=True,
                      what="psi"),
                _span(10, "stage2.download", 0.6),
                _span(11, "mesh.all_gather", 0.1 * scale, 10,
                      bytes=3 * 10**8),
                _span(12, "stage2.d2h", 0.5 * scale, 10, bytes=10**9)],
            "process": {"kernels.load": {"count": 7, "host_s": 1.5},
                        "transform.plan": {"count": 9, "host_s": 2.5}}}


@pytest.fixture(scope="module")
def readers():
    got = harness.metric_readers()
    assert set(NEW_METRICS) <= set(got)
    return got


def test_span_metrics_read_a_hand_made_card_context(readers):
    ctx = {"cubes": [_card_cube(1.0), _card_cube(2.0)]}
    want = {
        "stage2.h2d_gbps": ((1.001 / 0.201 + 1.001 / 0.402) / 2, "GB/s"),
        "stage2.d2h_gbps": ((1 / 0.5 + 1 / 1.0) / 2, "GB/s"),
        "solver.pocs_s": ((1.0 + 2.0) / 2, "s"),
        "mesh.collective_s": ((0.151 + 0.302) / 2, "s"),
        "mesh.collective_gb": (0.501, "GB"),
        "setup.build_s": (4.0, "s")}
    for name, (value, unit) in want.items():
        got = readers[name](ctx)
        assert got[1] == unit, name
        assert got[0] == pytest.approx(value, rel=1e-12), name


def test_span_metrics_read_nothing_in_cpu_walls(readers, traced):
    timings = traced[3]
    walls = dict(timings, cube=1.0)
    for name in NEW_METRICS[:5]:
        assert readers[name]({"cubes": [walls]}) is None, name
    got = readers["setup.build_s"]({"cubes": [walls]})
    assert got == (sum(v["host_s"] for v in timings["process"].values()),
                   "s")


def test_span_metrics_read_nothing_without_spans(readers):
    walls = {"upload": 0.3, "solve": 2.0, "download": 0.6, "cube": 3.0}
    for name in NEW_METRICS:
        assert readers[name]({"cubes": [walls, walls]}) is None, name
    # a mesh of one: spans, but no collective among them
    one = _card_cube()
    one["spans"] = [s for s in one["spans"]
                    if not s["name"].startswith("mesh.")]
    assert readers["mesh.collective_s"]({"cubes": [one]}) is None
    assert readers["mesh.collective_gb"]({"cubes": [one]}) is None
    assert readers["solver.pocs_s"]({"cubes": [one]})[0] == pytest.approx(
        1.0)


def test_stage2_spans_script_rehearses_on_the_cpu(tmp_path, capsys):
    """``stage2_spans.py --tiny``: the pairs, the traced cube's gaps put
    down to spans, and its checks, at 32x32x64 on the CPU."""
    import stage2_spans

    stage2_spans.main(["--tiny", "fft_eps_cube_1chip", "--pairs", "2",
                       "--out", str(tmp_path)])
    report = json.loads((tmp_path / "report.json").read_text())
    got = report["fft_eps_cube_1chip"]
    assert len(got["timings_none"]) == len(got["timings_dict"]) == 2
    trace = got["trace"]
    assert trace["device_synchronize"] == 0  # the laps sync on a card only
    assert all(trace["checks"].values())
    assert trace["span_count"]["solver.batch"] == 5  # 33 bins, batch 8
    assert (tmp_path / "fft_eps_cube_1chip.trace.json.gz").is_file()
