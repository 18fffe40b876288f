"""Run one cell of the benchmark of ``pseudo_3d_interpolation_torch`` once.

    python3 p3d_bench/run.py --workload shearlet_cube_1chip --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cell's CUDA cards. It
makes the seeded cube on the card, warms up every shape the cell uses,
sends whole cubes through ``pipeline.stage2.interpolate_time_cube_sharded``
in a closed loop for ``--seconds``, checks the last result against the
plain reference in ``reference/``, and prints one JSON line last on
standard output: the end-to-end metrics with ``--trace 0``, the per-layer
metrics of ``metrics/`` and a breakdown of one traced cube with
``--trace 1``. A cell on more than one card starts one process a card
itself (NCCL over tcp://127.0.0.1), and its rank 0 prints. Without the
cell's cards it exits non-zero and prints no result: there is no CPU
fallback.
"""

from __future__ import annotations

import time

T_START = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)  # the harness is imported as the package p3d_bench
sys.path.insert(0, str(ROOT))
# every build and kernel cache of the run stays at a fixed place in the
# checkout (the port's own CUDA libraries go to its _build/)
CACHE = ROOT / ".p3d_bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
RUN_DEADLINE_S = 340  # a multi-card run ends its ranks after this


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-card cell, as the first process starts it
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, help=argparse.SUPPRESS)
    return ap


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script: Path, argv: list[str], chips: int,
          deadline_s: float | None = RUN_DEADLINE_S) -> int:
    """One process a card running ``script`` with ``argv`` and its rank,
    rank 0 writing to this standard output; wait for every rank, and end
    them all if one fails or ``deadline_s`` passes."""
    from p3d_bench import harness
    from pseudo_3d_interpolation_torch.ops.kernels import _build

    _build.build()  # once, before the ranks load the libraries
    port = free_port()
    procs = []
    for r in range(chips):
        cmd = [sys.executable, str(script), *argv, "--rank", str(r),
               "--port", str(port), "--t-start", repr(T_START)]
        procs.append(subprocess.Popen(
            cmd, stdout=None if r == 0 else sys.stderr,
            env=dict(os.environ, LOCAL_RANK=str(r))))
    code = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            late = (deadline_s is not None
                    and time.time() - T_START > deadline_s)
            if failed or late:
                code = failed[0] if failed else 124
                harness.log(f"a rank ended with {code}: ending the others"
                            if failed else "the ranks ran past the deadline")
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return code or next((p.returncode for p in procs if p.returncode), 0)


def card_cell(name: str):
    """The cell, or an exit code where it cannot run here: no such cell,
    no CUDA card, or fewer cards than it needs."""
    from p3d_bench import harness

    try:
        cell = harness.load_cell(name)
    except harness.BenchError as exc:
        harness.log(str(exc))
        return 2
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA card: the benchmark measures the port on the "
                    "card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"cell {cell.name} needs {cell.chips} CUDA cards, "
                    f"this machine has {torch.cuda.device_count()}")
        return 2
    return cell


def join_ranks(cell, args):
    """This rank's (Ranks, device), the process group joined on a
    multi-card cell."""
    import torch

    from p3d_bench import harness

    rank = args.rank or 0
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    if cell.chips > 1:
        from pseudo_3d_interpolation_torch.parallel import mesh as mesh_lib

        mesh_lib.initialize_distributed(f"127.0.0.1:{args.port}",
                                        cell.chips, rank, backend="nccl")
    return harness.Ranks(rank, cell.chips, device), device


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from p3d_bench import harness

    cell = card_cell(args.workload)
    if isinstance(cell, int):
        return cell
    if args.rank is None and cell.chips > 1:
        return spawn(HERE / "run.py", [
            "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cell.chips)
    ranks, device = join_ranks(cell, args)
    return harness.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                            args.t_start or T_START, ranks, device)


if __name__ == "__main__":
    sys.exit(main())
