"""PyTorch / CUDA port of the pseudo-3D seismic interpolation framework.

A second package beside ``pseudo_3d_interpolation_tpu`` (the JAX
reference, which stays as it is). It keeps the JAX package's module paths
and public names, so each counterpart is easy to find, and its public
functions take complex data as ``Cplx(re, im)`` float32 pairs, batch first.
Every kernel the JAX package wrote in Pallas for the TPU gets a counterpart
written by hand for Hopper (``csrc/``), beside a plain PyTorch version of
the same function.

Ported so far: the stage-2 frequency-slice solve on the FFT basis,
``pipeline.pocs.interpolate`` -> ``parallel.solver`` ->
``models.pocs.pocs_interpolate`` -> ``ops.kernels.pocs_solve``.
This module imports no submodule, so importing the package needs only
torch and numpy.
"""

__version__ = "0.1.0"

__all__ = ["compat", "io", "models", "ops", "parallel", "pipeline",
           "__version__"]
