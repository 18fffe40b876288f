"""Numerics on Cplx pairs (DFT, thresholds, decay); kernels in ``kernels``."""
