"""Workflow steps: 09 segy2cube, 10 binning, stage 2 (preprocess -> fft ->
POCS -> ifft -> postprocess) and 16 the export to SEG-Y."""
