"""The benchmark of ``pseudo_3d_interpolation_torch``: see ``run.py``."""
