"""Finite discrete shearlet transform (FFST-style) for the SHEARLET basis,
and the fused subband apply both spectral-stack bases (SHEARLET, CURVELET)
share.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/shearlet.py``: Meyer-
windowed cone-adapted shearlets with precomputed real Fourier windows
``Psi`` (L, H, W), pointwise normalised into an exactly tight frame, so
``x == Σ_l ifft2(fft2(x)·Psi_l·Psi_l)``. The windows and the support-cropped
plan are numpy, built exactly as the JAX package builds them (bit-equal);
device copies are made explicitly, on the caller's device, and cached.

The POCS hot path is :func:`pocs_subband_apply`, the fused
``inverse(threshold(forward(z)))``. On a CUDA tensor it runs the kernel
route (the top-level ``torch.fft`` spectrum, the ``subband_update`` kernel
over the full-size bands and one ``box_group_update`` launch per support-
cropped box group, one inverse; with ``P3D_SPATIAL_IO`` set, the spatial
route of ``subband_update_spatial``; with a ``*-percentile`` threshold,
the two kernels split at the threshold around a per-band selection); on a
CPU tensor the plain streamed route, which never materialises the
(B, L, H, W) coefficient stack.
Subband order matches FFST: 0 = lowpass, then per scale j (coarse -> fine)
2^(j+2) directional subbands.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..utils import timing
from . import dft
from .cplx import Cplx
from .threshold import threshold_pair


def _meyer_aux(x):
    """Meyer auxiliary polynomial v(x), v(0)=0, v(1)=1, C^3 smooth."""
    x = np.clip(x, 0.0, 1.0)
    return x**4 * (35.0 - 84.0 * x + 70.0 * x**2 - 20.0 * x**3)


def _b_window(w):
    """Meyer bump b(ω): support 1 <= |ω| <= 4."""
    w = np.abs(w)
    out = np.zeros_like(w)
    m1 = (w >= 1) & (w <= 2)
    out[m1] = np.sin(np.pi / 2.0 * _meyer_aux(w[m1] - 1.0))
    m2 = (w > 2) & (w <= 4)
    out[m2] = np.cos(np.pi / 2.0 * _meyer_aux(w[m2] / 2.0 - 1.0))
    return out


def _psi1_hat(w):
    """Radial window: sqrt(b²(2ω) + b²(ω)), support 1/2 <= |ω| <= 4."""
    return np.sqrt(_b_window(2.0 * w) ** 2 + _b_window(w) ** 2)


def _psi2_hat(w):
    """Angular window: sqrt(v(1+ω)) for ω<=0, sqrt(v(1−ω)) for ω>0;
    support |ω|<=1."""
    out = np.zeros_like(w)
    neg = w <= 0
    out[neg] = np.sqrt(_meyer_aux(1.0 + w[neg]))
    out[~neg] = np.sqrt(_meyer_aux(1.0 - w[~neg]))
    return out


def _phi_hat(w):
    """Scaling window: 1 for |ω|<=1/2, Meyer rolloff to 0 at |ω|=1."""
    w = np.abs(w)
    out = np.zeros_like(w)
    out[w <= 0.5] = 1.0
    m = (w > 0.5) & (w <= 1.0)
    out[m] = np.cos(np.pi / 2.0 * _meyer_aux(2.0 * w[m] - 1.0))
    return out


def n_subbands(n_scales: int) -> int:
    return 1 + sum(2 ** (j + 2) for j in range(n_scales))


def default_scales(h: int, w: int) -> int:
    """Reference scale count: floor(0.5·log2(max(shape)))."""
    s = int(np.floor(0.5 * np.log2(max(h, w))))
    return max(s, 1)


@functools.lru_cache(maxsize=8)
@timing.builds("transform.plan")
def shearlet_spectra(h: int, w: int, n_scales: int | None = None
                     ) -> np.ndarray:
    """The (L, H, W) shearlet windows (numpy float32, fft layout), real,
    normalised pointwise so that Σ_l Psi_l² == 1 (tight frame)."""
    if n_scales is None:
        n_scales = default_scales(h, w)
    w1 = np.fft.ifftshift(np.arange(-(h // 2), (h + 1) // 2))[:, None].astype(
        np.float64)
    w2 = np.fft.ifftshift(np.arange(-(w // 2), (w + 1) // 2))[None, :].astype(
        np.float64)
    W1 = np.broadcast_to(w1, (h, w))
    W2 = np.broadcast_to(w2, (h, w))

    psis = [_phi_hat(np.maximum(np.abs(W1), np.abs(W2)) / 1.0)]  # lowpass

    with np.errstate(divide="ignore", invalid="ignore"):
        tan_h = np.where(W1 != 0, W2 / W1, 0.0)  # horizontal cone
        tan_v = np.where(W2 != 0, W1 / W2, 0.0)  # vertical cone

    cone_h = np.abs(W2) <= np.abs(W1)
    cone_v = ~cone_h

    for j in range(n_scales):
        a = 4.0 ** (-j)
        if j == n_scales - 1:
            # finest scale: the radial window stays flat out to the grid
            # corner, so the plane is covered up to Nyquist
            r_h = np.where(np.abs(a * W1) >= 1.0, 1.0, _psi1_hat(a * W1))
            r_v = np.where(np.abs(a * W2) >= 1.0, 1.0, _psi1_hat(a * W2))
        else:
            r_h = _psi1_hat(a * W1)
            r_v = _psi1_hat(a * W2)
        for k in range(-(2**j), 2**j + 1):
            ang_h = _psi2_hat((2.0**j) * tan_h + k)
            ang_v = _psi2_hat((2.0**j) * tan_v + k)
            if abs(k) < 2**j:
                # interior shears: separate horizontal and vertical subbands
                psis.append(np.where(cone_h, r_h * ang_h, 0.0))
                psis.append(np.where(cone_v, r_v * ang_v, 0.0))
            elif k == 2**j:
                # seam subbands, glued across the cone boundary
                psis.append(np.where(cone_h, r_h * ang_h, r_v * ang_v))
                psis.append(
                    np.where(cone_h, r_h * _psi2_hat((2.0**j) * tan_h - k),
                             r_v * _psi2_hat((2.0**j) * tan_v - k)))

    psi = np.stack(psis).astype(np.float64)
    if psi.shape[0] != n_subbands(n_scales):
        raise RuntimeError(f"built {psi.shape[0]} subbands, expected "
                           f"{n_subbands(n_scales)}")
    return symmetrize_and_tighten(psi,
                                  f"shearlet ({h},{w}) {n_scales} scales")


def symmetrize_and_tighten(psi: np.ndarray, what: str) -> np.ndarray:
    """Reflect-symmetrise (Psi(ω) == Psi(−ω), as FFST's realCoefficients)
    and pointwise Parseval-normalise a window stack (Σ_l Psi_l² == 1)."""

    def _reflect(p):
        return np.roll(np.roll(p[::-1, ::-1], 1, axis=0), 1, axis=1)

    psi = np.sqrt(0.5 * (psi**2 + np.stack([_reflect(p) for p in psi]) ** 2))

    total = np.sqrt(np.sum(psi**2, axis=0))
    if total.min() <= 1e-6:
        raise RuntimeError(
            f"{what}: window system does not cover the frequency plane "
            f"(min coverage {total.min():.2e})")
    psi = psi / total[None]
    return psi.astype(np.float32)


def shearlet_transform(z: Cplx, psi) -> Cplx:
    """Forward transform without a plan: (..., H, W) -> (..., L, H, W)
    subband coefficients ``ifft2(fft2(z)·ψ_l)``. ``psi``: the (L, H, W)
    windows, numpy or a tensor."""
    zf = torch.fft.fft2(_complex(z))
    p = torch.as_tensor(psi, dtype=torch.float32, device=zf.device)
    return _pair(torch.fft.ifft2(zf[..., None, :, :] * p))


def inverse_shearlet_transform(coeffs: Cplx, psi) -> Cplx:
    """Adjoint and inverse (tight frame) without a plan: the sum of the
    re-windowed subband spectra, (..., L, H, W) -> (..., H, W)."""
    cf = torch.fft.fft2(_complex(coeffs))
    p = torch.as_tensor(psi, dtype=torch.float32, device=cf.device)
    return _pair(torch.fft.ifft2(torch.sum(cf * p, dim=-3)))


# ---------------------------------------------------------------------------
# Support-cropped plan. Every subband of scale j lives in the centred
# frequency box |ω| <= 4^(j+1); the coefficient fields keep full H×W
# resolution (the threshold acts there), only the transforms are cropped.
# ---------------------------------------------------------------------------

class _ScaleGroup:
    """Plan entry: frequency-box indices (None = full size) and the cropped
    windows, numpy, with per-device copies made on request."""

    __slots__ = ("idx_h", "idx_w", "psi", "_dev")

    def __init__(self, idx_h, idx_w, psi):
        self.idx_h = idx_h  # (sr,) int32 fft-layout row indices, or None
        self.idx_w = idx_w
        self.psi = psi      # (Lg, sr, sc) float32
        self._dev = {}

    def _cached(self, key, make):
        if key not in self._dev:
            with timing.build_span("transform.plan", what=key[0]):
                self._dev[key] = make()
        return self._dev[key]

    def psi_on(self, device) -> torch.Tensor:
        """The window stack on ``device`` (copied once per device)."""
        device = torch.device(device)
        return self._cached(("psi", str(device)),
                            lambda: torch.from_numpy(self.psi).to(device))

    def support_on(self, device):
        """The windows' row support (``kernels.subband.RowSupport``: the
        rows each window touches) with its table on ``device``, built once
        on the host and copied once per device."""
        from .kernels.subband import row_support_on

        device = torch.device(device)
        return self._cached(("support", str(device)),
                            lambda: row_support_on(self.psi, device))

    def index_on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(idx_h, idx_w) as int64 tensors on ``device``."""
        device = torch.device(device)
        return self._cached(("idx", str(device)), lambda: (
            torch.from_numpy(self.idx_h.astype(np.int64)).to(device),
            torch.from_numpy(self.idx_w.astype(np.int64)).to(device)))

    def box_index_on(self, h: int, w: int, device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(idx_h, idx_w) as int32 on ``device`` (a
        ``kernels.subband.BoxIndex``, with the percentile route's row-pass
        form for idx_w, ``box_line_plan``): the box kernel scatters and
        gathers each box line at these, so they are checked once to be
        distinct and inside the h × w grid."""
        from .kernels.subband import BoxIndex, box_line_plan

        device = torch.device(device)

        def make():
            for idx, n in ((self.idx_h, h), (self.idx_w, w)):
                if (len(np.unique(idx)) != len(idx) or idx.min() < 0
                        or idx.max() >= n):
                    raise ValueError(f"box indices {idx} are not distinct "
                                     f"indices into a side of {n}")
            return BoxIndex(
                torch.from_numpy(self.idx_h.astype(np.int32)).to(device),
                torch.from_numpy(self.idx_w.astype(np.int32)).to(device),
                box_line_plan(self.idx_w, w))
        return self._cached(("idx32", h, w, str(device)), make)

    def box_mats_on(self, h: int, w: int, device):
        """The box kernel's partial-DFT matrices A = F[idx] as float32
        (ahr, ahi, awr, awi), (sr, H) and (sc, W), on ``device``."""
        device = torch.device(device)

        def make():
            fhr, fhi = dft.dft_matrices(h)
            fwr, fwi = dft.dft_matrices(w)
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in (fhr[self.idx_h], fhi[self.idx_h],
                                   fwr[self.idx_w], fwi[self.idx_w]))
        return self._cached(("mats", h, w, str(device)), make)

    def partial_on(self, h: int, w: int, device):
        """(A_h, A_w) of :meth:`box_mats_on` as complex64, for the plain
        partial DFTs."""
        ahr, ahi, awr, awi = self.box_mats_on(h, w, device)
        return self._cached(("cmats", h, w, str(device)), lambda: (
            torch.complex(ahr, ahi), torch.complex(awr, awi)))


class Plan(tuple):
    """A tuple of :class:`_ScaleGroup` plus ``perm``: the planned subband
    order.

    The planned transforms emit subbands in plan order (groups
    concatenated); ``perm[i]`` is the canonical (FFST/curvelet) subband
    index at planned position i. Fine-scale splitting only reorders within
    a scale block, so scale-indexed consumers (the adaptive minimum's
    ``j_of_band``) are unaffected; thresholds ``tau`` are in plan order,
    and ``perm`` maps them to the unplanned transform's."""

    def __new__(cls, groups, perm):
        return super().__new__(cls, groups)

    def __init__(self, groups, perm):
        self.perm = np.asarray(perm, np.int64)
        self._pack = None


def _box_indices(n: int, bound: int, mult: int = 8) -> np.ndarray:
    """fft-layout indices of the frequencies |ω| <= bound, extended with
    frequencies just above +bound (where every window is zero) to a side
    that is a multiple of ``mult``, as the JAX plan pads its boxes."""
    idx = np.concatenate([np.arange(bound + 1),
                          np.arange(n - bound, n)]).astype(np.int32)
    side = len(idx)
    target = min(-(-side // mult) * mult, n)
    if target > side:
        idx = np.concatenate([idx, np.arange(bound + 1, bound + 1 + target
                                             - side, dtype=np.int32)])
    return idx


def build_plan(psi: np.ndarray, counts, bounds,
               split_threshold: int | None = None) -> Plan:
    """Group a (L, H, W) window stack into support-cropped plan entries:
    ``counts[g]`` consecutive subbands form group g, whose windows are zero
    outside the centred box |ω| <= ``bounds[g]`` (None = full size). A
    window with energy outside its box raises.

    Fine-scale splitting (``split_threshold=<box side>``; off by default,
    JAX ops/shearlet.py:293-363): a scale group of more than one subband
    whose box side (``min(H, W)`` for a full-size group) reaches the
    threshold is re-grouped by each subband's exact nonzero row and column
    support, subbands with identical supports batched together (the ±k
    shear pairs). Such a group's index lists are the exact support, not a
    centred box: the k=0 shear at 512² lives on 450 rows × 65 columns. A
    group whose support is the whole grid stays full size. The subband
    order is recorded in ``Plan.perm`` (the identity when nothing is
    split)."""
    h, w = psi.shape[-2:]
    groups = []
    perm = []
    l0 = 0
    for cnt, bound in zip(counts, bounds):
        idxs = np.arange(l0, l0 + cnt)
        l0 += cnt
        side = 2 * bound + 1 if bound is not None else min(h, w)
        if (split_threshold is not None and side >= split_threshold
                and cnt > 1):
            keymap = {}
            for l in idxs:
                nz = np.abs(psi[l]) > 0
                rows = np.nonzero(nz.any(axis=1))[0].astype(np.int32)
                cols = np.nonzero(nz.any(axis=0))[0].astype(np.int32)
                key = (rows.tobytes(), cols.tobytes())
                if key not in keymap:
                    keymap[key] = (rows, cols, [])
                keymap[key][2].append(int(l))
            for rows, cols, members in keymap.values():
                perm.extend(members)
                if len(rows) >= h and len(cols) >= w:
                    groups.append(_ScaleGroup(None, None, psi[members]))
                else:
                    groups.append(_ScaleGroup(rows, cols, np.ascontiguousarray(
                        psi[members][:, rows][:, :, cols])))
            continue
        perm.extend(idxs.tolist())
        sub = psi[idxs[0]:idxs[-1] + 1]
        if bound is None or side >= min(h, w):
            groups.append(_ScaleGroup(None, None, sub))
            continue
        ih = _box_indices(h, bound)
        iw = _box_indices(w, bound)
        outside = np.ones((h, w), bool)
        outside[np.ix_(ih, iw)] = False
        leak = np.abs(sub[:, outside]).max() if outside.any() else 0.0
        if leak != 0.0:
            raise ValueError(
                f"scale group leaks outside its box: {leak} — the plan's "
                "bound underestimates this scale's support")
        groups.append(_ScaleGroup(
            ih, iw, np.ascontiguousarray(sub[:, ih][:, :, iw])))
    if l0 != psi.shape[0]:
        raise ValueError(f"plan counts cover {l0} of {psi.shape[0]} "
                         "subbands")
    return Plan(groups, perm)


@functools.lru_cache(maxsize=8)
@timing.builds("transform.plan")
def shearlet_plan(h: int, w: int, n_scales: int | None = None,
                  split_threshold: int | None = None) -> Plan:
    """Per-scale support-cropped window groups (host, cached);
    ``split_threshold`` as :func:`build_plan`'s."""
    if n_scales is None:
        n_scales = default_scales(h, w)
    psi = shearlet_spectra(h, w, n_scales)
    counts = [1 + 4] + [2 ** (j + 2) for j in range(1, n_scales)]
    bounds = [4] + [4 ** (j + 1) for j in range(1, n_scales)]
    # the finest radial window is flat out to the grid corner: full size
    bounds[-1] = None
    return build_plan(psi, counts, bounds, split_threshold)


def _plan_kernel_pack(plan: Plan, h: int, w: int):
    """The plan packed for the kernels (JAX ``_plan_pallas_pack`` with
    ``layout='natural'``): (a group of the full-size windows (Lf, H, W),
    their plan-order indices, [(l0, lg, group)] of the box groups). A box
    group whose sides reach a quarter of the slice's (the 136-side scale at
    512²) is zero-padded to full size and joins the full-size bands. Cached
    on the plan."""
    if plan._pack is not None and plan._pack[0] == (h, w):
        return plan._pack[1]
    full_psi, full_idx, boxes = [], [], []
    l0 = 0
    for g in plan:
        lg = g.psi.shape[0]
        psi = g.psi
        if g.idx_h is not None and (len(g.idx_h) * 4 >= h
                                    and len(g.idx_w) * 4 >= w):
            psi = np.zeros((lg, h, w), np.float32)
            psi[:, g.idx_h[:, None], g.idx_w[None, :]] = g.psi
        elif g.idx_h is not None:
            boxes.append((l0, lg, g))
            l0 += lg
            continue
        full_psi.append(psi)
        full_idx.extend(range(l0, l0 + lg))
        l0 += lg
    # the finest scale is always full size, so there is a full-size group
    full = _ScaleGroup(None, None, np.ascontiguousarray(
        np.concatenate(full_psi)))
    pack = (full, np.asarray(full_idx, np.int64), boxes)
    plan._pack = ((h, w), pack)
    return pack


def _complex(z: Cplx) -> torch.Tensor:
    return torch.complex(z.re, z.im)


def _pair(c: torch.Tensor) -> Cplx:
    return Cplx(c.real.contiguous(), c.imag.contiguous())


def _partial_ifft2(v: torch.Tensor, ah: torch.Tensor, aw: torch.Tensor
                   ) -> torch.Tensor:
    """ifft2 of a spectrum that is zero outside a frequency box: complex
    (..., sr, sc) box values -> (..., H, W), scaled 1/(H·W). ``ah``/``aw``
    are the box's partial-DFT rows F[idx], (sr, H) and (sc, W)."""
    h, w = ah.shape[1], aw.shape[1]
    return (ah.conj().T @ v @ aw.conj()) / (h * w)


def _partial_fft2(x: torch.Tensor, ah: torch.Tensor, aw: torch.Tensor
                  ) -> torch.Tensor:
    """fft2 evaluated only at a box of output frequencies: complex
    (..., H, W) -> (..., sr, sc)."""
    return ah @ x @ aw.T


def shearlet_transform_planned(z: Cplx, plan: Plan) -> Cplx:
    """Forward transform: (..., H, W) -> (..., L, H, W) coefficients."""
    h, w = z.shape[-2], z.shape[-1]
    zf = torch.fft.fft2(_complex(z))
    outs = []
    for g in plan:
        p = g.psi_on(zf.device)
        if g.idx_h is None:
            outs.append(torch.fft.ifft2(zf[..., None, :, :] * p))
        else:
            ih, iw = g.index_on(zf.device)
            box = zf[..., ih[:, None], iw[None, :]]
            outs.append(_partial_ifft2(box[..., None, :, :] * p,
                                       *g.partial_on(h, w, zf.device)))
    return _pair(torch.cat(outs, dim=-3))


def inverse_shearlet_transform_planned(coeffs: Cplx, plan: Plan) -> Cplx:
    """Inverse (adjoint of a tight frame): Σ of re-windowed subband
    spectra, (..., L, H, W) -> (..., H, W)."""
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    c_all = _complex(coeffs)
    acc = torch.zeros(c_all.shape[:-3] + (h, w), dtype=c_all.dtype,
                      device=c_all.device)
    l0 = 0
    for g in plan:
        lg = g.psi.shape[0]
        c = c_all[..., l0:l0 + lg, :, :]
        l0 += lg
        p = g.psi_on(c.device)
        if g.idx_h is None:
            acc = acc + torch.sum(torch.fft.fft2(c) * p, dim=-3)
        else:
            ih, iw = g.index_on(c.device)
            v = torch.sum(_partial_fft2(c, *g.partial_on(h, w, c.device))
                          * p, dim=-3)
            acc[..., ih[:, None], iw[None, :]] += v
    return _pair(torch.fft.ifft2(acc))


def _pocs_subband_apply_streamed(z: Cplx, plan: Plan, tau, thresh_op: str
                                 ) -> Cplx:
    """The plain streamed route (JAX ops/shearlet.py:675-729 with
    ``_box_group_spatial``): one subband at a time, so the working set is a
    few (B, H, W) slices. Full-size groups window the top-level spectrum;
    box groups take their box spectrum as a partial fft2 of the spatial
    iterate and return through one partial ifft2 of the window-weighted
    summed box. Subbands are summed in plan order."""
    h, w = z.shape[-2], z.shape[-1]
    x = _complex(z)
    zf = torch.fft.fft2(x)
    acc = torch.zeros_like(zf)
    extra = torch.zeros_like(zf)
    l0 = 0
    for g in plan:
        p_stack = g.psi_on(x.device)
        if g.idx_h is None:
            for k in range(p_stack.shape[0]):
                p = p_stack[k]
                c = torch.fft.ifft2(zf * p)
                c = _complex(threshold_pair(_pair(c), tau[..., l0 + k,
                                                          None, None],
                                            kind=thresh_op))
                acc = acc + torch.fft.fft2(c) * p
        else:
            ah, aw = g.partial_on(h, w, x.device)
            xbox = _partial_fft2(x, ah, aw)
            m = torch.zeros_like(xbox)
            for k in range(p_stack.shape[0]):
                p = p_stack[k]
                c = _partial_ifft2(xbox * p, ah, aw)
                c = _complex(threshold_pair(_pair(c), tau[..., l0 + k,
                                                          None, None],
                                            kind=thresh_op))
                m = m + _partial_fft2(c, ah, aw) * p
            extra = extra + _partial_ifft2(m, ah, aw)
        l0 += p_stack.shape[0]
    return _pair(torch.fft.ifft2(acc) + extra)


def spatial_io_default() -> bool:
    """Whether ``P3D_SPATIAL_IO`` selects the spatial route, as in the JAX
    package (ops/shearlet.py:578)."""
    return bool(os.environ.get("P3D_SPATIAL_IO"))


def _pocs_subband_apply_kernels(z: Cplx, plan: Plan, tau, thresh_op: str,
                                precision: str, box_precision: str,
                                spatial_io: bool = False) -> Cplx:
    """The kernel route (JAX ``_pocs_subband_apply_pallas``, natural
    layout). On CUDA tensors it launches the kernels; on CPU tensors the
    wrappers take their plain versions (the CPU tests' check of the route).

    Spectral route: the top-level spectrum from ``torch.fft``, one
    ``subband_update`` launch over the full-size bands, one
    ``box_group_update`` launch per box group, one inverse. The box
    spectrum is gathered from the top-level spectrum and each group's
    window-weighted summed box is added into the accumulator before the one
    inverse. The JAX package takes a partial fft2 of the spatial iterate
    instead and adds a partial ifft2 of each box after the inverse: the
    same linear maps, so the two differ by rounding only.

    A ``*-percentile`` ``thresh_op`` (``tau`` then holds the percentiles)
    takes the split kernels, ``subband_update_percentile`` and
    ``box_group_update_percentile``, in the same places: each band's
    threshold is the percentile of |c_l| over the full H×W (the box
    groups' full N_h × N_w field), selected on the card between the two
    passes of each kernel.

    ``spatial_io`` (JAX ``P3D_SPATIAL_IO``): the JAX structure, one
    ``subband_update_spatial`` launch on the spatial iterate over the
    full-size bands, then per box group the box spectrum from a partial
    fft2 of the iterate, one ``box_group_update`` launch, and a partial
    ifft2 of its result added to the spatial output. The JAX package takes
    this route only in its permuted layout (square slices with a fast
    split); the port's kernel takes any H×W, so here it applies to every
    shape. It does not apply to the percentile forms, which the JAX
    package never sends to ``_kernel_spatial`` (its Pallas route refuses
    them)."""
    from .kernels.subband import (box_group_update,
                                  box_group_update_percentile,
                                  subband_update, subband_update_percentile,
                                  subband_update_spatial)

    percentile = thresh_op.endswith("-percentile")
    if percentile:
        # the split kernels; the spatial form has no percentile route
        spatial_io = False
        subband_update = subband_update_percentile
        box_group_update = box_group_update_percentile
    b, h, w = z.re.shape
    full, full_idx, boxes = _plan_kernel_pack(plan, h, w)
    device = z.re.device
    tau2 = torch.as_tensor(tau, dtype=torch.float32, device=device)
    if tau2.dim() == 1:
        tau2 = tau2[None]
    # the kernels read tau[b, l] for every slice: a shared (1, L) tau is
    # materialised to (B, L)
    tau2 = tau2.expand(b, tau2.shape[-1])
    idx = full._cached(("full_idx", str(device)),
                       lambda: torch.from_numpy(full_idx).to(device))
    tau_full = tau2[:, idx].contiguous()

    def box_operands(g):
        """The box update's (mats, index): the plain version's partial-DFT
        rows on the host, the kernel's indices on the card."""
        if device.type == "cpu":
            return g.box_mats_on(h, w, device), None
        return None, g.box_index_on(h, w, device)

    if spatial_io:
        z = Cplx(z.re.contiguous(), z.im.contiguous())
        out = _complex(subband_update_spatial(
            z, full.psi_on(device), tau_full, thresh_op, precision,
            support=full.support_on(device)))
        x = _complex(z)
        for l0, lg, g in boxes:
            ah, aw = g.partial_on(h, w, device)
            mats, index = box_operands(g)
            m = box_group_update(_pair(_partial_fft2(x, ah, aw)),
                                 g.psi_on(device),
                                 tau2[:, l0:l0 + lg].contiguous(), mats, h, w,
                                 thresh_op, box_precision, index=index)
            out += _partial_ifft2(_complex(m), ah, aw)
        return _pair(out)
    zf = torch.fft.fft2(_complex(z))
    acc = _complex(subband_update(_pair(zf), full.psi_on(device), tau_full,
                                  thresh_op, precision,
                                  support=full.support_on(device)))
    for l0, lg, g in boxes:
        ih, iw = g.index_on(device)
        sel = (slice(None), ih[:, None], iw[None, :])
        mats, index = box_operands(g)
        m = box_group_update(_pair(zf[sel]), g.psi_on(device),
                             tau2[:, l0:l0 + lg].contiguous(), mats, h, w,
                             thresh_op, box_precision, index=index)
        acc[sel] += _complex(m)
    return _pair(torch.fft.ifft2(acc))


def pocs_subband_apply(z: Cplx, plan: Plan, tau, thresh_op: str,
                       precision: str = "highest",
                       box_precision: str | None = None) -> Cplx:
    """``inverse(threshold(forward(z)))`` without the (B, L, H, W)
    coefficient stack: the kernel route for CUDA tensors, the plain
    streamed route for CPU tensors.

    ``z``: (B, H, W) pair; ``tau``: (B, L) or (L,) per-subband thresholds
    in plan order (what the transform's decay emits per iteration);
    ``precision``/``box_precision``: 'high', 'highest' or 'default', all
    computed in full fp32 (the box groups take ``box_precision``, default
    ``precision``). A ``*-percentile`` ``thresh_op`` reads ``tau`` as the
    percentiles of |c| per (slice, subband) and takes the split kernels on
    the card. With ``P3D_SPATIAL_IO`` set (:func:`spatial_io_default`, the
    one reader of the switch, which the device budget reads too) the
    kernel route takes its spatial form (``subband_update_spatial``), for
    every slice shape, the percentile forms excepted."""
    if box_precision is None:
        box_precision = precision
    if z.re.dim() != 3:
        raise ValueError(f"z must be a (B, H, W) pair, got "
                         f"{tuple(z.re.shape)}")
    if z.re.device.type == "cpu":
        tau = torch.as_tensor(tau, dtype=torch.float32)
        return _pocs_subband_apply_streamed(z, plan, tau, thresh_op)
    return _pocs_subband_apply_kernels(z, plan, tau, thresh_op, precision,
                                       box_precision, spatial_io_default())


def subband_stats(z: Cplx, plan: Plan):
    """Per-subband (max |c|, Σ|c|²) of the transform of ``z``, one subband
    at a time (the decay schedule needs only these two reductions). Returns
    two (..., L) tensors in plan order."""
    h, w = z.shape[-2], z.shape[-1]
    zf = torch.fft.fft2(_complex(z))
    maxes, sumsqs = [], []
    for g in plan:
        p_stack = g.psi_on(zf.device)
        if g.idx_h is not None:
            ih, iw = g.index_on(zf.device)
            box = zf[..., ih[:, None], iw[None, :]]
            ah, aw = g.partial_on(h, w, zf.device)
        for k in range(p_stack.shape[0]):
            if g.idx_h is None:
                c = torch.fft.ifft2(zf * p_stack[k])
            else:
                c = _partial_ifft2(box * p_stack[k], ah, aw)
            a2 = c.real * c.real + c.imag * c.imag
            maxes.append(torch.sqrt(torch.amax(a2, dim=(-2, -1))))
            sumsqs.append(torch.sum(a2, dim=(-2, -1)))
    return torch.stack(maxes, dim=-1), torch.stack(sumsqs, dim=-1)
