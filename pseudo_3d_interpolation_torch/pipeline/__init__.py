"""Workflow steps: stage 1 (01-08), 09 segy2cube, 10 binning, stage 2
(preprocess -> fft -> POCS -> ifft -> postprocess), 16 the export to
SEG-Y, and the orchestrator that chains them from one config; ``stage2``
runs the fft -> POCS -> ifft span over a mesh of processes."""

from . import binning  # noqa: F401
from . import fft  # noqa: F401
from . import ifft  # noqa: F401
from . import pocs  # noqa: F401
from . import stage2  # noqa: F401
