"""Helpers shared by the port's tests (imports no JAX: the card tests run
where there is none)."""

import numpy as np

# a relative gap this wide is far above the float32 rounding of either
# implementation (about 1e-6 of a slice's largest coefficient)
MIN_GAP = 1e-4


def gap_taus(mags: np.ndarray) -> np.ndarray:
    """(B, L, N) coefficient magnitudes -> (B, L) float32 thresholds, each
    in the widest relative gap between neighbouring magnitudes from the
    80th to the 95th percentile. No coefficient then lies within float32
    rounding of its threshold, so a hard threshold keeps the same
    coefficients however the arithmetic is ordered, and two
    implementations can be held to the soft thresholds' elementwise
    bound. A band without such a gap (one whose magnitudes are all equal,
    as the lowpass band of a box holding only the zero frequency) gets
    half its smallest magnitude: it keeps every coefficient."""
    out = np.empty(mags.shape[:2], np.float32)
    for idx in np.ndindex(*mags.shape[:2]):
        m = np.sort(mags[idx])
        seg = m[int(0.8 * m.size):int(0.95 * m.size)]
        with np.errstate(divide="ignore", invalid="ignore"):
            gaps = np.nan_to_num((seg[1:] - seg[:-1]) / seg[1:])
        k = int(np.argmax(gaps))
        out[idx] = (np.sqrt(seg[k] * seg[k + 1]) if gaps[k] > MIN_GAP
                    else 0.5 * m[0])
    return out


class MemoryCube:
    """An in-memory cube with ``CubeFile``'s slab methods and
    ``CubeWriter``'s: the source and the sink of the port's streamed
    passes (``preprocess_slabs``, ``postprocess_slabs``) without files.
    The arrays stay numpy on the host, where the files would be; a slab
    read is a copy, as a file read is. ``bytes_read`` and
    ``bytes_written`` count the slabs' bytes."""

    def __init__(self, coords, attrs=None, coord_attrs=None):
        self.bytes_read = self.bytes_written = 0
        self.coords = {k: np.asarray(v) for k, v in coords.items()}
        self.attrs = dict(attrs or {})
        self.coord_attrs = {k: dict(v) for k, v in (coord_attrs or {}).items()}
        self.data_vars = {}  # name -> dims, as CubeFile's
        self.var_attrs = {}
        self.arrays = {}

    @classmethod
    def from_cube(cls, cube):
        """A port ``Cube`` as a source (its arrays shared, not copied)."""
        mem = cls(cube.coords, cube.attrs, cube.coord_attrs)
        for name, (dims, data) in cube.data_vars.items():
            mem.data_vars[name] = tuple(dims)
            mem.arrays[name] = np.asarray(data)
            mem.var_attrs[name] = dict(cube.var_attrs.get(name, {}))
        return mem

    def dims_of(self, var):
        return self.data_vars[var]

    def primary_var(self):
        from pseudo_3d_interpolation_torch.io.cube import primary_var_name

        return primary_var_name(self.data_vars)

    def sizes(self):
        return {d: len(c) for d, c in self.coords.items()}

    def is_complex(self, var):
        return np.iscomplexobj(self.arrays[var])

    def dtype_of(self, var):
        return self.arrays[var].dtype

    def _sel(self, var, dim, start, stop):
        return tuple(slice(start, stop) if d == dim else slice(None)
                     for d in self.data_vars[var])

    def read_slab(self, var, dim=None, start=0, stop=None):
        out = np.array(self.arrays[var][self._sel(var, dim, start, stop)])
        self.bytes_read += out.nbytes
        return out

    def read(self, var):
        return self.read_slab(var)

    def create_var(self, name, dims, dtype, chunks=None, attrs=None):
        shape = tuple(len(self.coords[d]) for d in dims)
        self.data_vars[name] = tuple(dims)
        self.arrays[name] = np.empty(shape, dtype)
        self.var_attrs[name] = dict(attrs or {})

    def write_slab(self, name, data, dim=None, start=0):
        data = np.asarray(data)
        self.bytes_written += data.nbytes
        n = data.shape[self.data_vars[name].index(dim)] if dim else None
        self.arrays[name][self._sel(name, dim, start,
                                    None if n is None else start + n)] = data

    def set_attrs(self, **kw):
        self.attrs.update(kw)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def to_cube(self):
        from pseudo_3d_interpolation_torch.io.cube import Cube

        return Cube(coords=dict(self.coords),
                    data_vars={k: (d, self.arrays[k])
                               for k, d in self.data_vars.items()},
                    attrs=dict(self.attrs),
                    var_attrs={k: dict(v) for k, v in self.var_attrs.items()},
                    coord_attrs={k: dict(v)
                                 for k, v in self.coord_attrs.items()})


class MemoryStore:
    """The streamed passes' store in memory: each writer a new
    :class:`MemoryCube`, read back as itself; ``final`` is the last final
    writer, ``cubes`` every writer."""

    def __init__(self):
        self.final = None
        self.cubes = []

    def writer(self, coords, attrs=None, coord_attrs=None, final=True):
        w = MemoryCube(coords, attrs, coord_attrs)
        self.cubes.append(w)
        if final:
            self.final = w
        return w

    def reader(self, writer):
        return writer

    def bytes_moved(self) -> int:
        """Bytes written to and read from the store's cubes."""
        return sum(c.bytes_read + c.bytes_written for c in self.cubes)
