"""In-memory cube container.

Counterpart of the ``Cube`` in ``pseudo_3d_interpolation_tpu/io/ncio.py``
(a minimal xarray.Dataset stand-in): named dims with coordinate arrays,
data variables over those dims, attribute dicts. The netCDF file I/O
(``read_cube``/``write_cube``, h5py) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import numpy as np

# data_vars names that are auxiliary layers, never the solve target
AUX_VARS = ("fold", "amp_ref", "mask")


@dataclasses.dataclass
class Cube:
    """coords (1-D arrays by dim name), data_vars (dim tuple + array),
    attrs (global, per variable, per coordinate)."""

    coords: dict[str, np.ndarray]
    data_vars: dict[str, tuple[tuple[str, ...], np.ndarray]]
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    var_attrs: dict[str, dict] = dataclasses.field(default_factory=dict)
    coord_attrs: dict[str, dict] = dataclasses.field(default_factory=dict)

    def dims_of(self, var: str) -> tuple[str, ...]:
        return self.data_vars[var][0]

    def append_history(self, entry: str):
        """Accumulate processing history like the reference's netCDF attrs."""
        today = datetime.date.today().isoformat()
        self.attrs["history"] = self.attrs.get("history", "") + f"{entry};"
        self.attrs["text"] = self.attrs.get("text", "") + f"\n{today}: {entry}"

    def primary_var(self) -> str:
        """The first data variable that is not an auxiliary layer."""
        var = next((v for v in self.data_vars if v not in AUX_VARS), None)
        if var is None:
            raise ValueError(
                "cube has no data variable besides fold/amp_ref/mask "
                f"(variables: {sorted(self.data_vars)})")
        return var
