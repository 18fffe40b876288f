"""Workflow steps: stage 1 (01-08), 09 segy2cube, 10 binning, stage 2
(preprocess -> fft -> POCS -> ifft -> postprocess), 16 the export to
SEG-Y, and the orchestrator that chains them from one config."""
