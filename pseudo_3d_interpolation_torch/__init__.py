"""PyTorch / CUDA port of the pseudo-3D seismic interpolation framework.

A second package beside ``pseudo_3d_interpolation_tpu`` (the JAX
reference, which stays as it is). It keeps the JAX package's module paths
and public names, so each counterpart is easy to find, and its public
functions take complex data as ``Cplx(re, im)`` float32 pairs, batch first.
Every kernel the JAX package wrote in Pallas for the TPU gets a counterpart
written by hand for Hopper (``csrc/``), beside a plain PyTorch version of
the same function.

Ported so far: SEG-Y profiles binned onto the grid
(``pipeline.binning.bin_cube``, stacks on the card; ``pipeline.segy2cube``
and the SEG-Y codec ``io.segy`` on the host), stage 2 on the time cube,
``pipeline.preprocess`` ->
``pipeline.fft`` -> ``pipeline.pocs.interpolate`` (``parallel.solver`` ->
``models.pocs.pocs_interpolate`` -> the kernels of ``ops.kernels``) ->
``pipeline.ifft`` -> ``pipeline.postprocess``, and the cube out as SEG-Y
(``pipeline.export.cube_to_segy``), with netCDF cube files on the host
(``io.ncio``). The solver runs every route of the JAX package:
the folded and per-iteration kernels, the directional scan over the
subband kernels, and the plain scan (``xla-scan``: the DCT and WAVELET
bases with early stopping, the cost history or APOCS, the percentile
thresholds, free masks and batches, the decimated CURVELET) as PyTorch
ops; ``models.pocs_interpolate_numpy`` takes numpy in and out.
Stage 1 (``pipeline.stage1``, steps 01-08) repairs the SEG-Y profiles
first. Users drive every step through ``cli`` (``p3d-torch``, the JAX
package's ``p3d`` with ``--device``) or one YAML through
``pipeline.orchestrator.run_pipeline``; ``qc`` draws the figures and
``backends`` reports what this machine offers.
This module imports no submodule, so importing the package needs only
torch and numpy.
"""

__version__ = "0.1.0"

__all__ = ["backends", "cli", "compat", "io", "models", "ops", "parallel",
           "pipeline", "qc", "utils", "__version__"]
