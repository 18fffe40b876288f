"""Tiny cells for the benchmark's CPU tests: a cell's files with the cube
cut to 32 x 32 x 64, 5 iterations and batches of 8, run on the CPU; the check samples every
frequency slice."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from p3d_bench import harness  # noqa: E402

SHAPE = [32, 32, 64]
NITER = 5
BATCH = 8
SLICES = SHAPE[2] // 2 + 1  # the check samples every slice


def tiny_cell(name: str, chips: int = 1) -> harness.Cell:
    """The cell ``name`` at the tiny size, its limits as committed."""
    cell = harness.load_cell(name)
    config = dict(cell.config, shape=SHAPE, niter=NITER, batch=BATCH)
    return cell._replace(config=config, chips=chips,
                         check=dict(cell.check, sample_slices=SLICES))
