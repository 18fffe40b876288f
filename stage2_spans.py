"""Stage 2's spans on the card: what recording them costs, and the
device's idle gaps put down to the span that holds each.

    python3 stage2_spans.py shearlet_cube_1chip fft_eps_cube_1chip \
        [--pairs 6] [--out DIR] [--tiny]

For each benchmark cell named (``p3d_bench/workloads/``, one card): the
kernels, the cell's seeded cube, a warm-up cube; then ``--pairs``
interleaved pairs of whole cubes through
``pipeline.stage2.interpolate_time_cube_sharded`` with ``timings=None``
and ``timings={}`` (host walls, host cube in to host cube out; median and
quartiles of each); then one cube under torch.profiler with
``timings={}``: its device idle gaps over 1 ms, each put down to the
innermost program span (a user annotation) that holds the gap's
midpoint, the device synchronisations inside the cube, each span's
device seconds beside its ``gpu_user_annotation`` ranges, each copy
span's bytes, whether it went through the staging ring (``staged``) and
in how many ``chunks``, and the checks that the spans' readings hold
together; and the process's ``stage2.staging`` builds. Prints one JSON
report last, and writes it with the gzipped Chrome traces to ``--out``.
``--tiny`` rehearses the script on the CPU at 32x32x64 (no device
numbers).
"""

import argparse
import gzip
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from p3d_bench import harness  # noqa: E402
from pseudo_3d_interpolation_torch.ops.kernels import _build  # noqa: E402
from pseudo_3d_interpolation_torch.pipeline import stage2  # noqa: E402
from pseudo_3d_interpolation_torch.utils import timing  # noqa: E402

SEED = 2**31 + 4242
GAP_US = 1000.0  # the idle gaps named: over 1 ms


def runner(config, inputs, mesh, niter=None):
    pc = harness.port_config(config, niter)
    tkw = {"precision": config["precision"]}

    def run(timings):
        t0 = time.perf_counter()
        stage2.interpolate_time_cube_sharded(
            inputs.cube, pc, mesh=mesh, batch=config["batch"],
            transform_kwargs=tkw, timings=timings)
        return time.perf_counter() - t0
    return run


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2],
            "spread": (q[2] - q[0]) / statistics.median(v)}


def traced(run, device, name, out):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        acts.append(ProfilerActivity.CUDA)
    timings = {}
    with profile(activities=acts) as prof:
        with record_function("stage2_spans.cube"):
            run(timings)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as fh:
            raw = fh.read()
    events = json.loads(raw)["traceEvents"]
    if out:
        with gzip.open(os.path.join(out, f"{name}.trace.json.gz"),
                       "wb") as fh:
            fh.write(raw)
    xs = [e for e in events if e.get("ph") == "X"]
    cube = [e for e in xs if e["name"] == "stage2_spans.cube"][0]
    lo, hi = cube["ts"], cube["ts"] + cube["dur"]
    dev = [e for e in xs if e.get("cat") in harness.DEVICE_CATS]
    names = {s["name"] for s in timings["spans"]}
    ann = [e for e in xs if e.get("cat") == "user_annotation"
           and e["name"] in names]
    gpu_ann = [e for e in xs if e.get("cat") == "gpu_user_annotation"]
    busy = harness._merged([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps, cursor = [], lo
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
    if cursor < hi:
        gaps.append((cursor, hi))
    gaps = [g for g in gaps if g[1] - g[0] > GAP_US]
    by_span, listed = {}, []
    for a, b in gaps:
        mid = (a + b) / 2
        holders = [e for e in ann if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = (min(holders, key=lambda e: e["dur"])["name"] if holders
                else "outside every span")
        by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e6
        listed.append([name, (a - lo) / 1e6, (b - a) / 1e6])
    syncs = [e for e in xs if "DeviceSynchronize" in e["name"]
             and lo <= e["ts"] <= hi]
    ann_dev = {}
    for e in gpu_ann:
        ann_dev.setdefault(e["name"], []).append(e["dur"] / 1e6)
    spans = timings["spans"]
    span_dev = {}
    for s in spans:
        if s["device_s"] is not None:
            span_dev.setdefault(s["name"], []).append(s["device_s"])
    walls = {k: timings[k] for k in ("upload", "solve", "download")}

    def dsum(name, parent=None):
        """The device seconds of the spans ``name`` (under ``parent``)."""
        return sum(s["device_s"] or 0.0 for s in spans
                   if s["name"] == name and (
                       parent is None or spans[s["parent"]]["name"] == parent))
    return {
        "wall": cube["dur"] / 1e6, "walls": walls,
        "busy": harness.union_seconds((e["ts"], e["ts"] + e["dur"])
                                      for e in dev),
        "device_synchronize": len(syncs),
        "gaps_over_1ms": len(gaps),
        "gap_s_by_span": sorted(by_span.items(), key=lambda kv: -kv[1]),
        "gaps": listed,
        "span_device_s": {k: [sum(v), len(v)] for k, v in span_dev.items()},
        "span_count": {k: sum(s["name"] == k for s in spans) for k in names},
        # each copy: name, bytes, staged, chunks, device seconds
        "copies": [[s["name"], s["attrs"]["bytes"], s["attrs"]["staged"],
                    s["attrs"]["chunks"], s["device_s"]] for s in spans
                   if s["name"] in ("stage2.h2d", "stage2.d2h")],
        "gpu_annotation_s": {k: [sum(v), len(v)] for k, v in ann_dev.items()},
        "checks": {
            "h2d_under_upload_le_upload": dsum("stage2.h2d", "stage2.upload")
            <= walls["upload"],
            "d2h_le_download": dsum("stage2.d2h") <= walls["download"],
            "pocs_lt_solve": dsum("solver.batch") < walls["solve"],
            "no_build_span": not [s for s in spans if s["build"]]},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    tiny, out = args.tiny, args.out
    if out:
        os.makedirs(out, exist_ok=True)
    if tiny:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        _build.build()
    mesh = harness.make_mesh(harness.Ranks(), device)
    report = {"card": harness.power_limit(), "torch": torch.__version__}
    for name in args.cells:
        cell = harness.load_cell(name)
        config = cell.config
        if tiny:
            config = dict(config, shape=[32, 32, 64], niter=5, batch=8)
        inputs = harness.make_inputs(config, SEED, device)
        runner(config, inputs, mesh, harness.WARMUP_NITER)({})
        run = runner(config, inputs, mesh)
        run(None)
        off, on = [], []
        for i in range(args.pairs):
            for with_t in ((False, True) if i % 2 == 0 else (True, False)):
                (on if with_t else off).append(run({} if with_t else None))
        got = {"timings_none": off, "timings_dict": on,
               "none": quartiles(off), "dict": quartiles(on),
               "process": timing.BUILDS.snapshot()}
        got["staging_builds"] = got["process"].get(
            "stage2.staging", {}).get("count", 0)
        got["trace"] = traced(run, device, name, out)
        report[name] = got
        print(json.dumps({name: {k: got[k] for k in ("none", "dict")}}),
              flush=True)
        del inputs
        if not tiny:
            torch.cuda.empty_cache()
    if out:
        with open(os.path.join(out, "report.json"), "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({k: (v if k in ("card", "torch") else
                          {"trace": {kk: vv for kk, vv in v["trace"].items()
                                     if kk not in ("gaps",)},
                           "process": v["process"],
                           "staging_builds": v["staging_builds"]})
                      for k, v in report.items()}, indent=1))


if __name__ == "__main__":
    main()
