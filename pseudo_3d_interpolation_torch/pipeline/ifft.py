"""Step 14 — inverse FFT: frequency cube back to the time domain.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/ifft.py``: inverts
the true-amplitude/true-phase forward transform (dropped filtered bins
included, through the stored nfft), with the reference's optional
envelope clip-to-zero and global min/max rescale. The spectrum goes to the
device once and the time cube comes back as float32 numpy.
"""

from __future__ import annotations

import logging
import os

from ..io.cube import Cube
from ..ops import spectral
from ..utils.device import resolve_device
from ..utils.rescale import rescale
from .fft import spectrum_from_cube

log = logging.getLogger(__name__)


def apply_ifft(
    cube: Cube | str,
    var: str | None = None,
    envelope_clip: bool = False,
    rescale_minmax: tuple[float, float] | None = None,
    attrs_config=None,
    out_path: str | None = None,
    verbose: int = 0,
    device=None,
) -> Cube:
    """``device`` defaults to the first CUDA card and raises without one;
    ``device='cpu'`` runs on the host. A path input and ``out_path`` are
    cube files (host, h5py)."""
    device = resolve_device(device)
    if isinstance(cube, (str, os.PathLike)):
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    if var is None:
        var = next((v for v in cube.data_vars if v.startswith("freq_")),
                   None)
        if var is None:
            raise ValueError(
                "cube has no freq_* spectral variable to invert — run the "
                f"fft step first (variables: {sorted(cube.data_vars)})")
    spec = spectrum_from_cube(cube, var, device)
    twt, x = spectral.inverse_fft_original(spec)
    del spec
    level = logging.INFO if verbose else logging.DEBUG
    log.log(level, "IFFT: %s bins -> %d samples",
            cube.data_vars[var][1].shape, x.shape[-1])

    if envelope_clip:
        # envelopes are non-negative by definition
        x = x.clamp(min=0.0)
    if rescale_minmax is not None:
        x = rescale(x, rescale_minmax[0], rescale_minmax[1])
    x = x.float().cpu().numpy()

    var_out = cube.var_attrs.get(var, {}).get("original_var",
                                              var.replace("freq_", ""))
    if isinstance(var_out, bytes):
        var_out = var_out.decode()
    dims = cube.dims_of(var)[:-1] + ("twt",)
    coords = {k: v for k, v in cube.coords.items() if k != "freq_twt"}
    coords["twt"] = twt
    out = Cube(
        coords=coords,
        data_vars={var_out: (dims, x)},
        attrs=dict(cube.attrs),
        coord_attrs={"twt": {"units": "s", "long_name": "two-way traveltime"}},
    )
    if "fold" in cube.data_vars:
        out.data_vars["fold"] = cube.data_vars["fold"]
    out.append_history(f"IFFT({var})")
    if attrs_config is not None:
        from ..io.ncio import apply_time_attrs

        apply_time_attrs(out, attrs_config)
    if out_path:
        from ..io.ncio import write_cube

        write_cube(out_path, out)
    return out
