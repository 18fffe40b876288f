"""2D affine transform for cube geometry (3x3 homogeneous matrices).

reference: pseudo_3D_interpolation/functions/transform.py:6-279 (``Affine``).
Re-designed as an immutable value class: every operation returns a new
``Affine`` (the reference mutates in place and returns self). Angles are in
degrees to match the reference's geometry configs. Point transforms are
vectorized numpy (host-side geometry metadata work; trace coordinate
streams are transformed in one matmul).

A copy of ``pseudo_3d_interpolation_tpu/ops/affine.py``, kept here:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


class Affine:
    """Immutable 2D affine transform backed by a (3, 3) homogeneous matrix."""

    __slots__ = ("matrix",)

    def __init__(self, scaling=1.0, translation=0.0, rotation=0.0, shear=0.0, matrix=None):
        if matrix is not None:
            m = np.asarray(matrix, float)
            if m.shape != (3, 3):
                raise ValueError("matrix must have shape (3, 3)")
            object.__setattr__(self, "matrix", m.copy())
            return
        sx, sy = self._pair(scaling)
        tx, ty = self._pair(translation)
        cx, cy = np.deg2rad(self._pair(shear))
        r = np.deg2rad(rotation)
        m = np.array(
            [
                [sx * np.cos(r), -np.sin(r) + cx, tx],
                [np.sin(r) + cy, sy * np.cos(r), ty],
                [0.0, 0.0, 1.0],
            ]
        )
        object.__setattr__(self, "matrix", m)

    @staticmethod
    def _pair(p):
        return (p, p) if np.isscalar(p) else tuple(p)

    def __setattr__(self, *a):  # immutability
        raise AttributeError("Affine is immutable; operations return new instances")

    def __repr__(self):
        return f"Affine({self.matrix!r})"

    # -- composition -------------------------------------------------------
    def __matmul__(self, other: "Affine") -> "Affine":
        """``(A @ B)(p) == A(B(p))``."""
        return Affine(matrix=self.matrix @ other.matrix)

    def then(self, other: "Affine") -> "Affine":
        """Apply ``self`` first, then ``other`` (readable chaining)."""
        return Affine(matrix=other.matrix @ self.matrix)

    def scaling(self, scale) -> "Affine":
        return self.then(Affine(scaling=scale))

    def translation(self, t) -> "Affine":
        return self.then(Affine(translation=t))

    def rotation(self, angle_deg: float) -> "Affine":
        return self.then(Affine(rotation=angle_deg))

    def shear(self, shear_deg) -> "Affine":
        return self.then(Affine(shear=shear_deg))

    def rotate_around(self, angle_deg: float, origin=(0.0, 0.0)) -> "Affine":
        """Rotation about an arbitrary origin (reference transform.py:120-126)."""
        o = np.asarray(origin, float)
        out = self.translation(tuple(-o))
        if angle_deg is not None:
            out = out.rotation(angle_deg)
        return out.translation(tuple(o))

    # -- application -------------------------------------------------------
    def inverse(self) -> "Affine":
        """Analytic inverse (reference transform.py:245-275)."""
        a, b, tx = self.matrix[0]
        c, d, ty = self.matrix[1]
        det = a * d - b * c
        if abs(det) < 1e-15:
            raise ValueError("singular affine matrix")
        inv = np.array(
            [
                [d / det, -b / det, (b * ty - d * tx) / det],
                [-c / det, a / det, (c * tx - a * ty) / det],
                [0.0, 0.0, 1.0],
            ]
        )
        return Affine(matrix=inv)

    def transform(self, points):
        """Apply to points of shape (N, 2) (or (2,)); returns same shape."""
        p = np.atleast_2d(np.asarray(points, float))
        hom = np.concatenate([p, np.ones((p.shape[0], 1))], axis=1)
        out = (self.matrix @ hom.T).T[:, :2]
        return out[0] if np.asarray(points).ndim == 1 else out

    def __call__(self, points):
        return self.transform(points)


def points_from_extent(extent):
    """(xmin, xmax, ymin, ymax) -> corner points [(ll), (ul), (ur), (lr)]."""
    xmin, xmax, ymin, ymax = extent
    return np.array([[xmin, ymin], [xmin, ymax], [xmax, ymax], [xmax, ymin]], float)


def coords_to_ilxl_transform(
    corner_points=None,
    extent=None,
    spacing=None,
    base_transform: Affine | None = None,
    inverted: bool = False,
):
    """Build the CRS-coordinates -> fractional (iline, xline) transform.

    Mirrors the reference's grid setup (cube_binning_3D.py:164-271): bin
    centers are inset half a bin from the corners, line counts come from the
    rounded corner distances, and lines number from 1. ``base_transform``
    (typically the rotation about the grid origin) composes on the input
    side.

    Returns (transform, n_ilines, n_xlines).
    """
    if corner_points is None and extent is None:
        raise ValueError("Either corner_points or extent must be specified")
    if spacing is None:
        raise ValueError("spacing must be specified")
    if corner_points is None:
        corner_points = points_from_extent(extent)
    corner_points = np.asarray(corner_points, float)
    if isinstance(spacing, (tuple, list)):
        yspacing, xspacing = spacing
    else:
        xspacing = yspacing = float(spacing)

    center_points = corner_points + np.array(
        [
            [xspacing / 2, yspacing / 2],
            [xspacing / 2, -yspacing / 2],
            [-xspacing / 2, -yspacing / 2],
            [-xspacing / 2, yspacing / 2],
        ]
    )
    dist_x = float(np.hypot(*(center_points[3] - center_points[0])))
    dist_y = float(np.hypot(*(center_points[1] - center_points[0])))
    # line counts = bin centers inclusive (center-to-center intervals + 1).
    # NOTE deviation: the reference counts only the intervals
    # (cube_binning_3D.py:254-255) while its transform produces indices
    # 1..intervals+1 — we keep count and index range consistent.
    n_ilines = int(np.around(dist_x / xspacing)) + 1
    n_xlines = int(np.around(dist_y / yspacing)) + 1

    # index step per CRS unit; a single-line axis (dist == 0) keeps the
    # bin-width scale 1/spacing so coordinates within the bin round to
    # line 1 AND the transform stays invertible (bin_cube needs inverse()
    # for the bin centers) instead of dividing by zero
    sx = (n_ilines - 1) / np.around(dist_x) if np.around(dist_x) > 0 else 1.0 / xspacing
    sy = (n_xlines - 1) / np.around(dist_y) if np.around(dist_y) > 0 else 1.0 / yspacing
    t = (
        Affine()
        .translation(tuple(-center_points[0]))
        .scaling((sx, sy))
        .translation((1.0, 1.0))  # lines start at 1
    )
    if base_transform is not None:
        t = t @ (base_transform.inverse() if inverted else base_transform)
    return t, n_ilines, n_xlines
