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
