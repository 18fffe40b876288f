"""Workflow steps: stage 2, preprocess -> fft -> POCS -> ifft -> postprocess."""
