"""QC / observability: plotting, solver inversion panels, metrics reports.

Counterpart of ``pseudo_3d_interpolation_tpu/qc``. Importing it needs no
matplotlib: ``qc.plot`` imports it inside the plotting functions."""

from .plot import (
    plot_iline_grid,
    plot_seismic_image,
    plot_seismic_difference,
    plot_seismic_wiggle,
    plot_seismic_wiggle_diff,
    plot_statics_overlay,
    plot_statics_panels,
    plot_trace_spectrum,
    plot_trace_freq_spectrum,
    plot_average_spectrum,
    plot_average_freq_spectrum,
    plot_inversion_result,
    plot_fold_map,
)

__all__ = [
    "plot_iline_grid",
    "plot_seismic_image",
    "plot_seismic_difference",
    "plot_seismic_wiggle",
    "plot_seismic_wiggle_diff",
    "plot_statics_overlay",
    "plot_statics_panels",
    "plot_trace_spectrum",
    "plot_trace_freq_spectrum",
    "plot_average_spectrum",
    "plot_average_freq_spectrum",
    "plot_inversion_result",
    "plot_fold_map",
]
