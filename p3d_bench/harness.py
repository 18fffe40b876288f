"""One run of one cell: set-up, the measured window, the traced cube, the
check against the plain reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by name:
``workloads/<cell>.json`` (its configuration, traffic, chips and the
limits of its check), ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a ``read(ctx)`` that returns the metric's
value, or None where the run has nothing for it to read) and
``reference/bases/<basis>.py`` (the configuration's basis: its reference,
its work count and the transform keys a configuration may give it in
``"transform"``).

The timed entry is ``pipeline.stage2.interpolate_time_cube_sharded`` of
``pseudo_3d_interpolation_torch``, called as the north-star runner calls
it: a host cube in, a host cube out, on a mesh of this process or of all
the cell's ranks (one process a card, rank 0 reports).
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import work
from .reference import bases as ref_bases
from .reference import cube as ref_cube
from .reference import pocs as ref_pocs

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pseudo_3d_interpolation_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_ATTEMPTS = 3  # the profiler now and then drops a trace's kernels
WARMUP_NITER = 4  # the warm-up cube's iterations: every branch of the scan
SIGNAL_SHARE = 1e-6  # a slice holds signal above this share of the most
TIME_METRIC = "cube_s"  # seconds a cube; a cell's own name may extend it


class BenchError(RuntimeError):
    """A cell, configuration or file the run cannot use."""


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind} file {path.relative_to(ROOT)}")
    with open(path) as fh:
        return json.load(fh)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    time_metric: str  # the end-to-end name of its seconds a cube: cube_s,
    # or cube_s.<kind> where the host sets the pace and the runs spread
    # wider (their own bound)


def load_cell(name: str) -> Cell:
    """The cell ``workloads/<name>.json`` with its configuration and
    traffic mix. A configuration whose basis the reference and the work
    count cannot take is refused here, before any card work."""
    cell = load_json("workloads", name)
    config = load_json("configs", cell["config"])
    try:
        ref_bases.shape_keys(config)
    except ref_bases.BasisError as exc:
        path = BENCH / "configs" / f"{cell['config']}.json"
        raise BenchError(f"configuration {path.relative_to(ROOT)}: {exc}"
                         ) from None
    traffic = load_json("traffic", cell["traffic"])
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise BenchError(f"traffic {cell['traffic']}: the harness drives "
                         "one client in a closed loop")
    if traffic["ranks"] != cell["chips"]:
        raise BenchError(f"cell {name}: traffic {cell['traffic']} runs "
                         f"{traffic['ranks']} ranks on {cell['chips']} chips")
    return Cell(name, int(cell["chips"]), config, traffic, cell["check"],
                cell["time_metric"])


def metric_readers() -> dict:
    """``{name: read}`` of every ``metrics/<name>.py``."""
    readers = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(
            "p3d_bench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[name] = mod.read
    return readers


def layer_name(name: str, cell: Cell) -> str:
    """The name a per-layer metric reports under in ``cell``: its file's
    name, with the kind that the cell's seconds-a-cube metric carries
    after ``cube_s.`` put before its last part (in a ``cube_s.host_paced``
    cell ``stage2.copy_s`` reports as ``stage2.host_paced.copy_s``), so
    that each per-layer metric moves the one end-to-end metric its cell
    reports."""
    if not cell.time_metric.startswith(TIME_METRIC):
        raise BenchError(f"cell {cell.name}: time metric "
                         f"{cell.time_metric!r} is not a {TIME_METRIC}")
    kind = cell.time_metric[len(TIME_METRIC) + 1:]
    if not kind:
        return name
    head, _, tail = name.rpartition(".")
    return f"{head}.{kind}.{tail}" if head else f"{kind}.{tail}"


def forbidden_modules() -> list[str]:
    """The forbidden top-level packages (compared whole) this process
    holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"p3d_bench: {msg}", file=sys.stderr, flush=True)


# --- the ranks ---------------------------------------------------------------

class Ranks:
    """This process's place among the cell's ranks, and the few
    collectives the harness itself needs (none on one rank)."""

    def __init__(self, rank: int = 0, world: int = 1, device=None):
        self.rank, self.world = rank, world
        self.device = torch.device(device) if device is not None else None

    def _dist(self):
        import torch.distributed as dist
        return dist

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        self._dist().broadcast(t, 0)
        return bool(t.item())

    def any(self, flag: bool) -> bool:
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        self._dist().all_reduce(t, self._dist().ReduceOp.MAX)
        return bool(t.item())

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        self._dist().all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.world > 1:
            self._dist().barrier()


# --- inputs ------------------------------------------------------------------

class Inputs(NamedTuple):
    truth: np.ndarray  # (h, w, t) float32, the dense cube
    obs: np.ndarray  # (h, w, t) float32, the bins kept
    mask: np.ndarray  # (h, w) float32
    cube: object  # the program's host Cube of ``obs``


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """The seeded cube, made on ``device`` and copied to the host once."""
    from pseudo_3d_interpolation_torch.io.cube import Cube

    dense = ref_cube.dense_cube(config, seed, device)
    mask = ref_cube.bin_mask(config, seed, device)
    obs = dense * mask[:, :, None]
    truth_h, obs_h, mask_h = (a.cpu().numpy() for a in (dense, obs, mask))
    del dense, obs, mask
    h, w, t = config["shape"]
    cube = Cube(
        coords={"iline": np.arange(h), "xline": np.arange(w),
                "twt": np.arange(t) * config["dt_s"]},
        data_vars={"amp": (("iline", "xline", "twt"), obs_h),
                   "fold": (("iline", "xline"), mask_h.astype(np.int32))})
    return Inputs(truth_h, obs_h, mask_h, cube)


def port_config(config: dict, niter: int | None = None):
    from pseudo_3d_interpolation_torch.models.pocs import POCSConfig

    return POCSConfig(
        niter=niter or config["niter"], thresh_op=config["thresh_op"],
        thresh_model=config["thresh_model"], eps=config["eps"],
        alpha=config["alpha"], p_max=config["p_max"], p_min=config["p_min"],
        version=config["version"], transform_kind=config["basis"])


def cube_runner(config: dict, inputs: Inputs, mesh, niter=None):
    """A function that sends the host cube through the timed entry once,
    with the configuration's ``"transform"`` keys and ``precision`` as
    the transform's keys: (the result's Cube, its walls: ``cube`` host to
    host, stage 2's ``upload``, ``solve`` and ``download``, and its
    ``spans`` and ``process``)."""
    from pseudo_3d_interpolation_torch.pipeline import stage2

    pc = port_config(config, niter)
    tkw = dict(config.get("transform", {}), precision=config["precision"])

    def run():
        walls: dict = {}
        t0 = time.perf_counter()
        res = stage2.interpolate_time_cube_sharded(
            inputs.cube, pc, mesh=mesh, batch=config["batch"],
            transform_kwargs=tkw, timings=walls)
        walls["cube"] = time.perf_counter() - t0
        return res, walls
    return run


# --- the window --------------------------------------------------------------

def measure_window(run, seconds: float, ranks: Ranks):
    """Whole cubes in a closed loop: a cube starts while fewer than
    ``seconds`` have passed since the first began; the window ends when
    the last is back on the host. (last result, per-cube walls, window
    wall)."""
    cubes, res, t_first = [], None, None
    while ranks.agree(t_first is None
                      or time.perf_counter() - t_first < seconds):
        if t_first is None:
            t_first = time.perf_counter()
        res, walls = run()
        cubes.append(walls)
    return res, cubes, time.perf_counter() - t_first


# --- the traced cube ---------------------------------------------------------

def _device_events(events):
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def union_seconds(intervals) -> float:
    """The union of (start, end) intervals in microseconds, in s."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(dev, host, span, longest: int = 200) -> list:
    """The device's idle gaps inside ``span`` (start, end): the ``longest``
    of them, each named by the host op that overlaps it most (host Python
    and numpy run no op), summed by name; the ten largest sums."""
    lo, hi = span
    busy = _merged([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps, cursor = [], lo
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
    if cursor < hi:
        gaps.append((cursor, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:longest]
    host = sorted(host, key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    by_name: dict = {}
    for a, b in gaps:
        best, overlap = "host Python or numpy (no op recorded)", 0.0
        # the ops that started within a second before the gap, or in it
        for e in host[bisect.bisect_left(starts, a - 1e6):
                      bisect.bisect_left(starts, b)]:
            ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if ov > overlap:
                best, overlap = e["name"], ov
        by_name[best] = by_name.get(best, 0.0) + (b - a) / 1e6
    return sorted(([k[:200], v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:10]


def trace_cube(run, device, ranks: Ranks) -> dict:
    """One cube under torch.profiler: its host wall, the device's busy
    time (the union of kernel, memcpy and memset intervals), the summed
    time of every kernel inside stage 2's solve (between the
    synchronisations that end its upload and its solve), the device's
    peak over the cube, and rank 0's breakdown. A trace whose kernels sum
    to under a tenth of the solve's wall dropped them: it is taken
    again."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("p3d_bench.cube"):
                _, walls = run()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        dev = _device_events(events)
        kernels = [e for e in dev if e["cat"] == "kernel"]
        ksum = sum(e["dur"] for e in kernels) / 1e6
        retake = ranks.any(ksum < 0.1 * walls["solve"])
        if not retake:
            break
        log(f"trace attempt {attempt} of {TRACE_ATTEMPTS}: {len(kernels)} "
            f"kernels, {ksum:.4f} s against a {walls['solve']:.3f} s solve; "
            "taken again")
    else:
        raise BenchError(f"no trace of {TRACE_ATTEMPTS} held the cube's "
                         "kernels")
    span = [e for e in events if e.get("name") == "p3d_bench.cube"
            and e.get("ph") == "X"]
    lo, hi = ((span[0]["ts"], span[0]["ts"] + span[0]["dur"]) if span
              else (min(e["ts"] for e in dev),
                    max(e["ts"] + e["dur"] for e in dev)))
    # stage 2's laps end with a device synchronisation each: the first
    # ends the upload, the last but one the solve, the last the download
    syncs = sorted((e for e in events if e.get("ph") == "X"
                    and "DeviceSynchronize" in e.get("name", "")
                    and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
    if len(syncs) >= 3:
        s_lo = syncs[0]["ts"] + syncs[0]["dur"]
        s_hi = syncs[-2]["ts"] + syncs[-2]["dur"]
        solve_k = [e for e in kernels
                   if e["ts"] >= s_lo and e["ts"] + e["dur"] <= s_hi]
    else:
        log(f"the traced cube holds {len(syncs)} device synchronisations, "
            "not stage 2's three: every kernel of the cube counted as the "
            "solve's")
        solve_k = kernels
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "cuda_runtime")]
    return {
        "wall": wall,
        "busy": union_seconds((e["ts"], e["ts"] + e["dur"]) for e in dev),
        "solve_kernel_s": sum(e["dur"] for e in solve_k) / 1e6,
        "solve_kernels": len(solve_k),
        "peak_bytes": peak,
        "device_ops": sorted(([k[:200], v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": idle_gaps(dev, host, (lo, hi)),
    }


# --- the check ---------------------------------------------------------------

def obs_spectrum(x: np.ndarray, dt: float, device, bins=None,
                 block: int = 32) -> torch.Tensor:
    """(f, h, w) complex128 spectrum of host traces ``x`` (h, w, t) at
    ``bins`` (all of them by default), ``block`` ilines at a time."""
    h, w, t = x.shape
    nb = t // 2 + 1 if bins is None else len(bins)
    out = torch.empty((nb, h, w), dtype=torch.complex128, device=device)
    idx = (torch.arange(nb, device=device) if bins is None
           else torch.as_tensor(bins, device=device))
    for r0 in range(0, h, block):
        xb = torch.from_numpy(x[r0:r0 + block]).to(device)
        out[:, r0:r0 + block] = ref_pocs.time_spectrum(xb, dt, idx)
    return out


def sample_slices(energy: torch.Tensor, n: int, seed: int) -> list[int]:
    """``n`` frequency slices drawn from ``seed``: the slice of most energy,
    and the rest uniformly from all the others (every rank's block and
    every batch alike); sorted."""
    e = energy.cpu().double()
    g = torch.Generator().manual_seed(int(seed) % ref_cube.SEED_MOD + 1)
    top = int(torch.argmax(e))
    others = [k for k in range(len(e)) if k != top]
    pick = [top] + [others[i] for i in torch.randperm(
        len(others), generator=g)[:max(0, min(n, len(e)) - 1)]]
    return sorted(pick)


def check_numbers(config: dict, cell_check: dict, inputs: Inputs,
                  out: np.ndarray | None, seed: int, device,
                  control: bool = False) -> dict:
    """The numbers that decide ``correct``: over a sample of frequency
    slices drawn from ``seed``, the reference's float64 solve R of the
    observed spectrum against the spectrum P of the program's output cube
    ``out`` (the irfft keeps no imaginary part of the DC and Nyquist bins,
    so neither does R there). With ``control`` the reference's TF32 solve
    takes the program's place.

    ``slice_rel_l2_p75``: the 75th percentile of ||P - R|| / ||R|| over
    the sampled slices that hold signal (energy above SIGNAL_SHARE of the
    strongest). ``slices_off_share``: the share of the sampled slices,
    every one of them, that read ||P - R|| / max(||R||, off_floor *
    ||R_top||) above ``off_above`` (R_top the strongest sampled slice), so
    that a slice far below the signal counts against the strongest
    slice's scale."""
    h, w, t = config["shape"]
    dt = config["dt_s"]
    spec = obs_spectrum(inputs.obs, dt, device)
    energy = (spec.abs() ** 2).sum(dim=(-2, -1))
    bins = sample_slices(energy, cell_check["sample_slices"], seed)
    z = spec[bins].contiguous()
    del spec
    mask = torch.from_numpy(inputs.mask).to(device)
    r, iters = ref_pocs.solve_slices(z, mask, config, "float64")
    edge = torch.tensor([k in (0, t // 2) for k in bins], device=device)
    r = torch.where(edge[:, None, None], r.real.to(r.dtype), r)
    if control:
        p, _ = ref_pocs.solve_slices(z, mask, config, "tf32")
        p = torch.where(edge[:, None, None], p.real.to(p.dtype), p)
    else:
        p = obs_spectrum(out, dt, device, bins)
    gap = torch.linalg.vector_norm(p - r, dim=(-2, -1))
    r_norm = torch.linalg.vector_norm(r, dim=(-2, -1))
    per = gap / r_norm.clamp_min(1e-300)
    off = gap / torch.maximum(r_norm, cell_check["off_floor"] * r_norm.max()
                              ).clamp_min(1e-300)
    share = energy[bins] / energy.max()
    sig = per[share >= SIGNAL_SHARE].double()
    n_off = int((off > cell_check["off_above"]).sum())
    return {"rel_l2": float(torch.linalg.vector_norm(gap)
                            / torch.linalg.vector_norm(r_norm)),
            "slice_rel_l2_p50": float(torch.quantile(sig, 0.5)),
            "slice_rel_l2_p75": float(torch.quantile(sig, 0.75)),
            "slices_off": n_off,
            "slices_off_share": n_off / len(bins),
            "slice_off_max": float(off.max()),
            "bins": bins,
            "slices": [[k, float(e), float(v), float(o), int(i)]
                       for k, e, v, o, i in zip(
                           bins, share.tolist(), per.tolist(), off.tolist(),
                           iters.tolist())]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {value, limit}}`` for each limited number;
    a number without a limit yet is not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, checks


def check(cell: Cell, inputs: Inputs, out: np.ndarray | None, seed: int,
          device, control: bool = False) -> tuple[bool, dict, dict]:
    """The check's numbers, judged against the cell's limits and logged:
    (correct, the limited numbers with their limits, every number)."""
    numbers = check_numbers(cell.config, cell.check, inputs, out, seed,
                            device, control)
    correct, checks = judge(numbers, cell.check["limits"])
    log(("control: " if control else "")
        + "sampled slices (bin, energy share, relative L2, against the "
        "floored norm, reference iterations): "
        + "; ".join(f"{k} {e:.3g} {v:.3g} {o:.3g} {i}"
                    for k, e, v, o, i in numbers["slices"]))
    log(f"relative L2 over the sample {numbers['rel_l2']!r}; over the "
        f"signal slices median {numbers['slice_rel_l2_p50']!r}, 75th "
        f"percentile {numbers['slice_rel_l2_p75']!r}; slices off "
        f"{numbers['slices_off']} of {len(numbers['bins'])} (largest "
        f"{numbers['slice_off_max']!r})")
    return correct, checks, numbers


# --- one run -----------------------------------------------------------------

def make_mesh(ranks: Ranks, device):
    from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib

    if ranks.world == 1:
        return mesh_lib.make_mesh(device=device)
    return mesh_lib.make_mesh()


class SetUp(NamedTuple):
    mesh: object
    inputs: Inputs
    run: object  # one cube through the timed entry
    setup_s: float


def set_up(cell: Cell, seed: int, t_start: float, ranks: Ranks,
           device) -> SetUp:
    """The kernels, the mesh, the seeded cube, and one warm-up cube at
    the cell's shapes through the timed entry; ``setup_s`` counted from
    ``t_start``."""
    from pseudo_3d_interpolation_torch.ops.kernels import _build

    config = cell.config
    cuda = torch.device(device).type == "cuda"
    phases = [("start to the harness", time.time() - t_start)]
    if cuda:
        _build.build()
    mesh = make_mesh(ranks, device)
    phases.append(("kernels built and the mesh", time.time() - t_start))
    inputs = make_inputs(config, seed, device)
    phases.append(("the seeded cube and its host copy",
                   time.time() - t_start))
    cube_runner(config, inputs, mesh, niter=WARMUP_NITER)()
    ranks.barrier()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    phases.append(("the warm-up cube", setup_s))
    if ranks.rank == 0:
        log("set-up " + ", ".join(f"{name} at {t:.3f} s"
                                  for name, t in phases))
    return SetUp(mesh, inputs, cube_runner(config, inputs, mesh), setup_s)


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, ranks: Ranks, device,
             keep_group: bool = False, sink: list | None = None) -> int:
    """Set-up, window, traced cube and check of one rank; rank 0 prints
    the result line (and appends its numbers to ``sink``). Returns the
    exit code. ``keep_group`` leaves a multi-rank process group joined
    for another run."""
    config = cell.config
    cuda = torch.device(device).type == "cuda"
    mesh, inputs, run, setup_s = set_up(cell, seed, t_start, ranks, device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    res, cubes, window_s = measure_window(run, seconds, ranks)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out = res.data_vars["amp"][1]
    mean_iters = float(res.attrs["pocs_mean_iterations"])
    del res
    traced = trace_cube(run, device, ranks) if trace else None

    every = ranks.gather({
        "solve": [c["solve"] for c in cubes], "peak": peak,
        "busy": traced and traced["busy"], "wall": traced and traced["wall"],
        "kernels": traced and traced["solve_kernel_s"]})
    del mesh, run
    if ranks.world > 1 and not keep_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    if ranks.rank != 0:
        return 0
    if cuda:
        torch.cuda.empty_cache()

    snr, snr_mag = ref_pocs.snr_db(inputs.truth, out, device)
    log(f"magnitude SNR (the north-star runner's measure): {snr_mag:.4f} dB"
        f"; amplitude SNR {snr:.4f} dB; sparse input "
        f"{ref_pocs.snr_db(inputs.truth, inputs.obs, device)[0]:.4f} dB")
    correct, checks, numbers = check(cell, inputs, out, seed, device)
    if sink is not None:
        sink.append({"cell": cell.name, "side": "program", "seed": seed,
                     "correct": correct, **numbers, "snr_db": snr,
                     "snr_mag_db": snr_mag, "walls": cubes[-1],
                     "mean_iterations": mean_iters})

    if trace:
        # the work bound is the whole cube's: held against every rank's
        # kernels in its share of the solve, summed
        traced["solve_kernel_s"] = sum(r["kernels"] for r in every)
        ctx = {"config": config, "cell": cell, "ranks": ranks.world,
               "cubes": cubes, "rank_solve_s": [r["solve"] for r in every],
               "mean_iterations": mean_iters, "trace": traced,
               "work": work.solve_work(config)}
        metrics = {}
        for name, read in metric_readers().items():
            got = read(ctx)
            if got is not None:
                value, unit = got
                metrics[layer_name(name, cell)] = {"value": value,
                                                   "unit": unit}
        log(f"solve work bound {ctx['work']['bound_s']:.6f} s "
            f"({ctx['work']['bound_by']}; H100 SXM data sheet at 700 W; "
            f"this card: {power_limit()}); kernels in the traced solve "
            f"{traced['solve_kernel_s']:.6f} s over the ranks, rank 0's "
            f"{traced['solve_kernels']} launches")
    else:
        metrics = {
            cell.time_metric: {"value": window_s / len(cubes), "unit": "s"},
            "snr_db": {"value": snr, "unit": "dB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    device_line = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": ranks.world,
        "memory_peak_bytes": max(r["peak"] for r in every)}
    result = {"correct": correct, "attempted": len(cubes), "failed": 0,
              "metrics": metrics, "device": device_line}
    if trace:
        device_line["busy_s"] = sum(r["busy"] for r in every) / ranks.world
        device_line["window_s"] = sum(r["wall"] for r in every) / ranks.world
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    log(f"window: {len(cubes)} cubes in {window_s:.4f} s; set-up "
        f"{setup_s:.4f} s; each cube's upload, solve, download, wall: "
        + "; ".join(" ".join(f"{c[k]:.4f}" for k in
                             ("upload", "solve", "download", "cube"))
                    for c in cubes))
    found = forbidden_modules()
    if found:
        log(f"the run holds {', '.join(found)}: no result")
        return 3
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return got.stdout.strip().splitlines()[0] if got.stdout.strip() else (
        "nvidia-smi printed nothing")


def calibrate_rank(cell: Cell, seeds, control_seeds, ranks: Ranks,
                   device) -> int:
    """The check's numbers for the program on each of ``seeds`` (a run of
    ``run_rank`` each, its window one cube) and for the control on each
    of ``control_seeds``, judged against the cell's limits; rank 0 prints
    one JSON line a seed."""
    rows: list = []
    for i, seed in enumerate(seeds):
        code = run_rank(cell, seed, 0.0, False, time.time(), ranks, device,
                        keep_group=i + 1 < len(seeds), sink=rows)
        if code:
            return code
        if ranks.rank == 0:
            print(json.dumps(rows.pop()), flush=True)
        if i + 1 < len(seeds):
            ranks.barrier()
    if ranks.world > 1 and not seeds:
        import torch.distributed as dist

        dist.destroy_process_group()
    if ranks.rank != 0:
        return 0
    for seed in control_seeds:
        inputs = make_inputs(cell.config, seed, device)
        t0 = time.perf_counter()
        correct, _, numbers = check(cell, inputs, None, seed, device,
                                    control=True)
        print(json.dumps({"cell": cell.name, "side": "control",
                          "seed": seed, "correct": correct, **numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    log(f"power limit: {power_limit()}")
    return 0
