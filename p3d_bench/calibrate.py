"""Read the numbers that decide ``correct`` over many seeds, for the
program and for the control, to set a cell's limits.

    python3 p3d_bench/calibrate.py --workload shearlet_cube_1chip \\
        --seeds 1 2 3 --control-seeds 4 5 6

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a
window of one cube, and prints the check's numbers against the plain
reference; for each of ``--control-seeds`` it prints the same numbers
with the reference's TF32 solve in the program's place. Each line says
whether the cell's committed limits judge it correct.
One JSON line a seed on standard output; a multi-card cell starts its
ranks as ``run.py`` does. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402  (sets up sys.path and the cache directories)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from p3d_bench import harness

    cell = run.card_cell(args.workload)
    if isinstance(cell, int):
        return cell
    if args.rank is None and cell.chips > 1:
        return run.spawn(Path(__file__).resolve(), [
            "--workload", args.workload,
            "--seeds", *map(str, args.seeds),
            "--control-seeds", *map(str, args.control_seeds)], cell.chips,
            deadline_s=None)
    ranks, device = run.join_ranks(cell, args)
    return harness.calibrate_rank(cell, args.seeds, args.control_seeds,
                                  ranks, device)


if __name__ == "__main__":
    sys.exit(main())
