"""Multilevel 2D discrete wavelet transform (periodized) in PyTorch.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/wavelet.py``: the
WAVELET sparse basis of the POCS solver (the reference's pywt
``wavedec2``/``waverec2``). The host filter builders are this package's own
copy of the JAX module's numpy code, so the filters and the one-level
analysis matrices (:func:`dwt_matrix`) are bit-equal to the JAX package's:
Daubechies ``db1``..``db20`` (``haar``) by spectral factorization, symlets
``sym2``..``sym12`` by least-asymmetric root selection, coiflets
``coif1``..``coif5`` from the tabulated machine-precision solutions.

The device boundary mode is periodization: a level is the orthogonal
matrix product ``M_h @ x @ M_wᵀ`` (the same linear map as the JAX package's
strided circular convolution), with fixed per-level shapes. Decomposition
returns the pywt-style list ``[cA_n, (cH_n, cV_n, cD_n), ..., (cH_1, cV_1,
cD_1)]``; cH is the horizontal detail (lowpass columns, highpass rows).
The pywt general-mode functions (``dwt2_mode``, ``idwt2_mode``,
``wavedec2_mode``, ``waverec2_mode``) are the JAX module's numpy code,
copied: host-side, float64, pywt's ragged per-level shapes, for users and
golden tests; the solver keeps the periodized path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# ---------------------------------------------------------------------------
# filter generation (host, exact)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def daubechies(p: int) -> np.ndarray:
    """Daubechies ``db-p`` scaling (lowpass) filter, length 2p, Σh = √2.

    Spectral factorization: roots of P(y) = Σ_k C(p-1+k, k) y^k are mapped
    to z-plane quadratic roots; the minimum-phase half (|z| < 1) forms
    m0(z) ∝ ((1+z)/2)^p Π(z - z_i). Float64 throughout; exact to ~1e-14
    (validated against the closed-form db2 in tests).
    """
    if p < 1:
        raise ValueError("order must be >= 1")
    if p == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    from math import comb

    ck = np.array([comb(p - 1 + k, k) for k in range(p - 1, -1, -1)], np.float64)
    yroots = np.roots(ck)  # roots of P(y), highest-power-first coeffs
    zroots = []
    for y in yroots:
        # y = (2 - z - 1/z)/4  =>  z^2 + (4y - 2) z + 1 = 0
        c = np.array([1.0, 4.0 * y - 2.0, 1.0])
        r = np.roots(c)
        zroots.append(r[np.argmin(np.abs(r))])  # minimum-phase root
    # polynomial ((1+z)/2)^p * prod (z - z_i), normalized
    poly = np.array([1.0 + 0j])
    for _ in range(p):
        poly = np.convolve(poly, [1.0, 1.0])
    for z in zroots:
        poly = np.convolve(poly, [1.0, -z])
    h = np.real(poly)
    h = h / np.sum(h) * np.sqrt(2.0)
    return h[::-1].copy()  # pywt orientation (h[0] smallest index)


@functools.lru_cache(maxsize=32)
def symlet(p: int) -> np.ndarray:
    """Symlet ``sym-p``: least-asymmetric orthogonal filter, length 2p.

    Same |m0(ω)|² as db-p, but the spectral-factorization roots are chosen
    (exhaustively over conjugate-pair in/out assignments, p <= 12) to
    minimize the phase nonlinearity of the filter — the standard
    least-asymmetric construction.
    """
    if p < 2:
        return daubechies(1)
    if p > 12:
        raise ValueError("symlets supported up to sym12 (exhaustive search)")
    from itertools import product
    from math import comb

    ck = np.array([comb(p - 1 + k, k) for k in range(p - 1, -1, -1)], np.float64)
    yroots = np.roots(ck)
    # group complex roots into conjugate pairs; reals stand alone
    used = np.zeros(len(yroots), bool)
    groups = []
    for i, y in enumerate(yroots):
        if used[i]:
            continue
        used[i] = True
        if abs(y.imag) < 1e-12:
            groups.append([y.real])
        else:
            j = int(np.argmin([
                abs(yroots[k] - np.conj(y)) + (1e18 if used[k] else 0)
                for k in range(len(yroots))
            ]))
            used[j] = True
            groups.append([y, yroots[j]])

    def z_of(y, inside: bool):
        r = np.roots([1.0, 4.0 * y - 2.0, 1.0])
        r = r[np.argsort(np.abs(r))]
        return r[0] if inside else r[1]

    def build(choice):
        poly = np.array([1.0 + 0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])
        for grp, inside in zip(groups, choice):
            for y in grp:
                poly = np.convolve(poly, [1.0, -z_of(y, inside)])
        h = np.real(poly)
        return h / np.sum(h) * np.sqrt(2.0)

    def asymmetry(h):
        # deviation of the group delay from constant (phase nonlinearity)
        w = np.linspace(0.01, np.pi - 0.01, 128)
        e = np.exp(-1j * np.outer(w, np.arange(len(h))))
        H = e @ h
        phase = np.unwrap(np.angle(H * np.exp(1j * w * (len(h) - 1) / 2)))
        return float(np.sum(np.diff(phase) ** 2))

    best, best_a = None, np.inf
    for choice in product([True, False], repeat=len(groups)):
        h = build(choice)
        a = asymmetry(h)
        if a < best_a:
            best, best_a = h, a
    return best[::-1].copy()


# Coiflets (the reference's production default is coif5 —
# cube_POCS_interpolation_3D.py:260-266). No closed-form construction
# exists; these are solved numerically to machine precision from the
# defining system (orthonormality + 2K vanishing wavelet moments + 2K-1
# vanishing scaling moments about index 4K-1, pywt dec_lo indexing), and
# the standard Daubechies branch is selected as the most-symmetric
# solution — a criterion validated to reproduce the published coif1-3
# tables exactly (see tools/gen_coiflets.py + tests). Filter length 6K.
_COIFLETS: dict[int, np.ndarray] = {}
_COIFLETS.update({
    1: np.array([
        -1.565572813579045597e-02, -7.273261951252657509e-02,  3.848648468648548926e-01,
         8.525720202116010560e-01,  3.378976624574838161e-01, -7.273261951252618651e-02,
    ]),
    2: np.array([
        -7.205494455206871984e-04, -1.823208870913646529e-03,  5.611434819373747884e-03,
         2.368017194685515664e-02, -5.943441864645114536e-02, -7.648859907828572946e-02,
         4.170051844232707250e-01,  8.127236354494067339e-01,  3.861100668227409050e-01,
        -6.737255472371633802e-02, -4.146493678686562212e-02,  1.638733646320024440e-02,
    ]),
    3: np.array([
        -3.459977319340140633e-05, -7.098330250289962284e-05,  4.662169598091125966e-04,
         1.117518770746506185e-03, -2.574517688009203553e-03, -9.007976136372899956e-03,
         1.588054486294974976e-02,  3.455502757272747860e-02, -8.230192710446351811e-02,
        -7.179982161894979398e-02,  4.284834763748662789e-01,  7.937772226265829012e-01,
         4.051769024110336570e-01, -6.112339000367350561e-02, -6.577191128224924022e-02,
         2.345269614244120671e-02,  7.782596425805136942e-03, -3.793512864450850064e-03,
    ]),
    4: np.array([
        -1.784990840619088415e-06, -3.259647722736805364e-06,  3.122986050990012030e-05,
         6.233885266366395728e-05, -2.599743331420795167e-04, -5.890202092412866186e-04,
         1.266561058798695329e-03,  3.751434619338495091e-03, -5.658283678332015620e-03,
        -1.521172799031417222e-02,  2.508225290796543827e-02,  3.933442235706786916e-02,
        -9.622042364831814854e-02, -6.662747228721255244e-02,  4.343860319745944110e-01,
         7.822389346274840616e-01,  4.153084279313731253e-01, -5.607731992407241628e-02,
        -8.126671072183243305e-02,  2.668230488539052869e-02,  1.606894726824416308e-02,
        -7.346168009679484787e-03, -1.629492442472461194e-03,  8.923139128453076371e-04,
    ]),
    5: np.array([
        -9.603865591505111876e-08, -1.623782781385793572e-07,  2.061201619364683157e-06,
         3.700686054260854396e-06, -2.127006479872572964e-05, -4.121956467774412491e-05,
         1.403556798190166120e-04,  3.018561097428429374e-04, -6.375565469737415336e-04,
        -1.661618189238586729e-03,  2.431563292542198232e-03,  6.761490908158349078e-03,
        -9.159455904927879533e-03, -1.975833423292232965e-02,  3.267465686429542326e-02,
         4.128746786414201619e-02, -1.055628898035992219e-01, -6.203773331337511521e-02,
         4.379819799059935792e-01,  7.742936731076652812e-01,  4.215715482206310871e-01,
        -5.204675510545994643e-02, -9.192175335173098649e-02,  2.816981130332392447e-02,
         2.340838551762623732e-02, -1.013161544695929950e-02, -4.159326985573953694e-03,
         2.178302159941913896e-03,  3.585792002815278365e-04, -2.120827215696717907e-04,
    ]),
})


@functools.lru_cache(maxsize=8)
def coiflet(K: int) -> np.ndarray:
    """Coiflet ``coif-K`` scaling filter (pywt dec_lo orientation)."""
    if K not in _COIFLETS:
        raise ValueError(f"coif{K} not available; have coif1..coif5")
    return _COIFLETS[K].copy()


_FAMILIES = {"haar": 1}
_FAMILIES.update({f"db{i}": i for i in range(1, 21)})
_FAMILIES.update({f"sym{i}": i for i in range(2, 13)})
_FAMILIES.update({f"coif{i}": i for i in range(1, 6)})


def wavelet_filters(name: str):
    """(dec_lo, dec_hi, rec_lo, rec_hi) for an orthogonal wavelet by name."""
    name = name.lower()
    if name not in _FAMILIES:
        raise ValueError(
            f"Wavelet {name!r} not available; choose one of {sorted(_FAMILIES)} "
            "(orthogonal Daubechies/Symlet families, generated exactly)"
        )
    if name.startswith("sym"):
        h = symlet(_FAMILIES[name]).astype(np.float32)
    elif name.startswith("coif"):
        h = coiflet(_FAMILIES[name]).astype(np.float32)
    else:
        h = daubechies(_FAMILIES[name]).astype(np.float32)
    L = h.size
    g = (h[::-1] * np.asarray([(-1.0) ** k for k in range(L)], np.float32)).astype(np.float32)
    # orthogonal: synthesis filters equal analysis filters (transpose op)
    return h, g, h, g


def filter_length(name: str) -> int:
    """Filter length by family: 2p for db/sym, 6K for coiflets."""
    name = name.lower()
    if name not in _FAMILIES:
        raise ValueError(
            f"wavelet {name!r} not available; choose one of "
            f"{sorted(_FAMILIES)}")
    return 6 * _FAMILIES[name] if name.startswith("coif") else 2 * _FAMILIES[name]


def max_level(n: int, name: str) -> int:
    """Max decomposition levels for axis length ``n`` (periodized).

    Returns 0 when the axis is shorter than the filter — decomposition is
    not possible (callers raise a clear error rather than wrapping
    incorrectly).
    """
    L = filter_length(name)
    lvl = 0
    while n % 2 == 0 and n >= L:
        n //= 2
        lvl += 1
    return lvl


@functools.lru_cache(maxsize=64)
def dwt_matrix(n: int, name: str = "db4") -> np.ndarray:
    """One-level periodized analysis as an orthogonal (n, n) matrix.

    Rows ``[0, n/2)`` are the lowpass analysis ``A_low[i, (2i+k) % n] = h[k]``
    and rows ``[n/2, n)`` the highpass — exactly :func:`_analysis_last`'s
    circular-correlation convention, so ``M @ x == dwt`` along the leading
    axis and ``M.T`` is the synthesis (the periodized DWT of an orthogonal
    wavelet is an orthogonal matrix). This is the matmul form the folded
    Pallas solve runs on the MXU (ops/pallas/pocs_iter.py): a 2D level is
    ``M @ x @ M.T`` with subbands landing as ll | cV / cH | cD quadrants.
    """
    h, g, _, _ = wavelet_filters(name)
    if n < h.size or n % 2:
        raise ValueError(f"axis length {n} too short/odd for wavelet {name!r}")
    return filter_matrix(h, g, n)


def filter_matrix(h: np.ndarray, g: np.ndarray, n: int) -> np.ndarray:
    """The (n, n) float32 periodized analysis matrix of the lowpass and
    highpass filters ``h``, ``g`` (length L <= n, n even): ``M[i, (2i+k) %
    n] = h[k]`` for the rows i < n/2, ``g[k]`` for the rows n/2 + i. The
    wavelet solve's kernel applies this map as a strided circular filter
    (ops/kernels/pocs_solve.wavelet_taps)."""
    L = h.size
    m = np.zeros((n, n), np.float32)
    cols = (2 * np.arange(n // 2)[:, None] + np.arange(L)[None, :]) % n
    np.put_along_axis(m[: n // 2], cols, np.broadcast_to(h, cols.shape), axis=1)
    np.put_along_axis(m[n // 2:], cols, np.broadcast_to(g, cols.shape), axis=1)
    return m


# ---------------------------------------------------------------------------
# 2D single level + multilevel (periodized, as matrix products)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def dwt_matrix_on(n: int, name: str, device: str) -> torch.Tensor:
    """:func:`dwt_matrix` as a float32 tensor on ``device``."""
    return torch.from_numpy(dwt_matrix(n, name)).to(device)


def dwt2(x: torch.Tensor, name: str = "db4"):
    """One 2D analysis level: (..., H, W) -> (cA, (cH, cV, cD))."""
    h, w = x.shape[-2], x.shape[-1]
    mh = dwt_matrix_on(h, name, str(x.device))
    mw = dwt_matrix_on(w, name, str(x.device))
    # columns first (lowpass | highpass along W), then rows
    y = torch.matmul(mh, torch.matmul(x, mw.T))
    h2, w2 = h // 2, w // 2
    return y[..., :h2, :w2], (y[..., h2:, :w2], y[..., :h2, w2:],
                              y[..., h2:, w2:])


def idwt2(ll: torch.Tensor, details, name: str = "db4") -> torch.Tensor:
    """Inverse of :func:`dwt2`."""
    lh, hl, hh = details
    y = torch.cat([torch.cat([ll, hl], dim=-1), torch.cat([lh, hh], dim=-1)],
                  dim=-2)
    mh = dwt_matrix_on(y.shape[-2], name, str(y.device))
    mw = dwt_matrix_on(y.shape[-1], name, str(y.device))
    return torch.matmul(torch.matmul(mh.T, y), mw)


def wavedec2(x: torch.Tensor, name: str = "db4", level: int | None = None):
    """Multilevel 2D DWT -> [cA_n, (cH_n, cV_n, cD_n), ..., (cH_1, ...)].

    Both trailing axes must be divisible by 2**level; ``level=None`` uses
    the maximum for the smaller axis.
    """
    h, w = x.shape[-2], x.shape[-1]
    if level is None:
        level = min(max_level(h, name), max_level(w, name))
    if level < 1:
        raise ValueError(
            f"slice {h}x{w} too short for wavelet {name!r} "
            f"(filter length {filter_length(name)}); pad the input "
            "(WaveletTransform.with_shape does this automatically)")
    L = filter_length(name)
    for s in (h, w):
        if s % (2**level):
            raise ValueError(f"axis length {s} not divisible by 2**{level}")
        if (s >> (level - 1)) < L:
            raise ValueError(
                f"level {level} too deep for axis length {s} with wavelet "
                f"{name!r}: the level-{level} axis ({s >> (level - 1)}) is "
                f"shorter than the filter ({L})")
    coeffs = []
    cur = x
    for _ in range(level):
        cur, det = dwt2(cur, name)
        coeffs.append(det)
    return [cur] + coeffs[::-1]


def waverec2(coeffs, name: str = "db4") -> torch.Tensor:
    """Inverse multilevel 2D DWT."""
    cur = coeffs[0]
    for det in coeffs[1:]:
        cur = idwt2(cur, det, name)
    return cur


# ---------------------------------------------------------------------------
# pywt-compatible general boundary modes ('smooth', 'symmetric', 'zero')
#
# replaces: pywt's padded dwt/idwt semantics — the reference's WAVELET
# production default is coif5 with mode='smooth'
# (cube_POCS_interpolation_3D.py:260-266). These produce pywt's ragged
# per-level coefficient lengths floor((N+L-1)/2), so they are host-side /
# non-batched by design; the POCS solver keeps the periodized fixed-shape
# path, whose boundary handling is immaterial to reconstruction SNR, while
# this path provides drop-in pywt-compatible decompositions for users and
# golden tests. dwt convention: out[i] = sum_j f[j] x_ext[2i+1-j]
# (PyWavelets downsampling_convolution); idwt = upsampled full synthesis
# convolution trimmed by L-2 per side.
# ---------------------------------------------------------------------------

def _extend(x, p: int, mode: str):
    """Pad the last axis by ``p`` samples each side per boundary mode."""
    if p == 0:
        return x
    if mode == "zero":
        pad = [(0, 0)] * (x.ndim - 1) + [(p, p)]
        return np.pad(x, pad)
    if mode == "symmetric":  # half-sample symmetry: ... x1 x0 | x0 x1 ...
        pad = [(0, 0)] * (x.ndim - 1) + [(p, p)]
        return np.pad(x, pad, mode="symmetric")
    if mode == "smooth":  # linear extrapolation with the edge slope
        k = np.arange(1, p + 1)
        left_slope = x[..., 1] - x[..., 0]
        right_slope = x[..., -1] - x[..., -2]
        left = x[..., :1] - left_slope[..., None] * k[::-1]
        right = x[..., -1:] + right_slope[..., None] * k
        return np.concatenate([left, x, right], axis=-1)
    raise ValueError(f"unsupported boundary mode {mode!r} "
                     "(use 'periodization' via wavedec2, or smooth/symmetric/zero)")


def _dwt1_mode(x, filt, mode: str):
    """1D analysis along the last axis, pywt general-mode convention."""
    x = np.asarray(x, np.float64)
    f = np.asarray(filt, np.float64)
    L = f.size
    n = x.shape[-1]
    n_out = (n + L - 1) // 2
    xp = _extend(x, L - 1, mode)
    # out[i] = sum_j f[j] * xp[2i + 1 - j + (L-1)] == correlate(xp, f[::-1])
    # windows starting at 2i+1
    idx = (2 * np.arange(n_out) + 1)[:, None] + np.arange(L)[None, :]
    return np.einsum("...nw,w->...n", xp[..., idx], f[::-1])


def _idwt1_mode(a, d, filt_lo, filt_hi, n_out: int):
    """1D synthesis (mode-independent): upsample, full conv, trim L-2/side."""
    lo = np.asarray(filt_lo, np.float64)
    hi = np.asarray(filt_hi, np.float64)
    L = lo.size
    o = a.shape[-1]
    up_len = 2 * o - 1

    def _acc(c, f):
        u = np.zeros(c.shape[:-1] + (up_len,), np.float64)
        u[..., ::2] = c
        full = np.apply_along_axis(lambda v: np.convolve(v, f), -1, u) \
            if u.ndim > 1 else np.convolve(u, f)
        return full

    # synthesis filters of an orthogonal bank = time-reversed analysis pair
    rec = _acc(a, lo[::-1]) + _acc(d, hi[::-1])
    if L > 2:
        rec = rec[..., L - 2 : -(L - 2)]
    return rec[..., :n_out]


def _filters_f64(name: str):
    """(dec_lo, dec_hi) in float64 — the general-mode path is host-side and
    keeps full precision (the f32 cast in wavelet_filters is for device)."""
    name = name.lower()
    if name not in _FAMILIES:
        raise ValueError(
            f"Wavelet {name!r} not available; choose one of {sorted(_FAMILIES)}")
    if name.startswith("sym"):
        h = symlet(_FAMILIES[name]).astype(np.float64)
    elif name.startswith("coif"):
        h = coiflet(_FAMILIES[name]).astype(np.float64)
    else:
        h = daubechies(_FAMILIES[name]).astype(np.float64)
    L = h.size
    g = h[::-1] * np.array([(-1.0) ** k for k in range(L)])
    return h, g


def dwt2_mode(x, name: str = "coif5", mode: str = "smooth"):
    """One pywt-style 2D analysis level with a general boundary mode."""
    h, g = _filters_f64(name)
    lo = _dwt1_mode(x, h, mode)
    hi = _dwt1_mode(x, g, mode)
    swap = lambda arr: np.swapaxes(arr, -1, -2)
    ll = swap(_dwt1_mode(swap(lo), h, mode))
    lh = swap(_dwt1_mode(swap(lo), g, mode))
    hl = swap(_dwt1_mode(swap(hi), h, mode))
    hh = swap(_dwt1_mode(swap(hi), g, mode))
    return ll, (lh, hl, hh)


def idwt2_mode(ll, details, name: str = "coif5", shape=None):
    """Inverse of :func:`dwt2_mode`; ``shape`` = target (H, W)."""
    lh, hl, hh = details
    h, g = _filters_f64(name)
    L = h.size
    th = shape[0] if shape else 2 * ll.shape[-2] - L + 2
    tw = shape[1] if shape else 2 * ll.shape[-1] - L + 2
    swap = lambda arr: np.swapaxes(arr, -1, -2)
    lo = swap(_idwt1_mode(swap(ll), swap(lh), h, g, th))
    hi = swap(_idwt1_mode(swap(hl), swap(hh), h, g, th))
    return _idwt1_mode(lo, hi, h, g, tw)


def wavedec2_mode(x, name: str = "coif5", level: int | None = None,
                  mode: str = "smooth"):
    """pywt-style multilevel 2D DWT with general boundary modes.

    Returns [cA_n, (cH_n, cV_n, cD_n), ...] with pywt's ragged per-level
    shapes; shapes are recorded for exact reconstruction."""
    x = np.asarray(x, np.float64)
    L = filter_length(name)
    if level is None:
        level = int(np.log2(min(x.shape[-2:]) / (L - 1))) if min(x.shape[-2:]) >= L else 0
        level = max(level, 1)
    coeffs = []
    shapes = []
    cur = x
    for _ in range(level):
        shapes.append(cur.shape[-2:])
        cur, det = dwt2_mode(cur, name, mode)
        coeffs.append(det)
    out = [cur] + coeffs[::-1]
    out_shapes = shapes[::-1]
    return out, out_shapes


def waverec2_mode(coeffs, shapes, name: str = "coif5"):
    """Inverse of :func:`wavedec2_mode` (exact perfect reconstruction)."""
    cur = coeffs[0]
    for det, shp in zip(coeffs[1:], shapes):
        cur = idwt2_mode(cur, det, name, shape=shp)
    return cur
