"""Numerics on Cplx pairs and traces (DFTs, thresholds, decay, signal
conditioning, filters, metrics); kernels in ``kernels``."""
