"""Fixed-iteration POCS solves (FFT, DCT and WAVELET bases) and the single
FFT-basis POCS iteration: the CUDA kernels' wrappers and their plain
PyTorch versions.

Replaces ``pseudo_3d_interpolation_tpu/ops/pallas/pocs_iter.py ::
pocs_solve_fused`` (kernel body ``_solve_kernel``, bases 'fft', 'dct' and
'wavelet'), which runs the whole solve of each slice in one Pallas launch
with the slice held in VMEM, and ``pocs_iteration_fused`` (body
``_kernel``), one iteration per launch. Holding a slice cannot carry over:
a 512² complex slice is 2 MB and a Hopper block has at most 227 KB of
shared memory. ``csrc/pocs_solve.cu`` instead enqueues, per iteration,
passes over the whole batch and one per-slice state kernel that takes the
FPOCS restart decision on the device. The FFT solve's passes, and the
single iteration's, are line FFTs on the ``csrc/fft_lines.cuh`` engine:
rows forward; columns forward, threshold and inverse; rows inverse with the
scale, the reinsertion and (the solve only) the cost's partial sums. The
DCT solve runs the same three passes with Makhoul's fast DCT around each
line FFT (a reordered load, a twiddled pairing of elements k and n − k
after the forward FFT and before the inverse, the samples stored back in
their places; :func:`dct_twiddles`), not products with the dense DCT
matrices. The WAVELET solve runs each level as one 2-D periodized filter
pass per direction through shared-memory tiles, the detail bands shrunk in
the forward pass, level 0's inverse with the reinsertion and the cost's
partial sums; the wrapper hands it the filters (:func:`wavelet_taps`), not
the matrices. All are bound by the memory their passes move; the file's
header has the details.

:func:`pocs_solve` and :func:`pocs_iteration` launch their kernels for
CUDA tensors and take their plain versions (:func:`pocs_solve_plain`,
:func:`pocs_iteration_plain`) only for CPU tensors.
``pocs_solve.launches_by_basis`` counts solve launches per basis,
``pocs_iteration.launches`` iteration launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import dft
from .. import wavelet as wv
from ..cplx import Cplx
from . import _build

THRESH_OPS = {"hard": 0, "soft": 1, "garrote": 2}
# the precision names a transform takes; every one runs in full fp32
PRECISIONS = ("highest", "high", "default")
BASES = ("fft", "dct", "wavelet")
# the longest line of the line-FFT kernels (csrc/fft_lines.cuh MAX_LINE)
MAX_LINE = 4096
# csrc/fft_lines.cuh: a line kernel's block (LINE_NT_MAX) and error codes
_LINE_NT_MAX = 512
_ERR_SMEM = -2
_ERR_SHAPE = -3


@functools.lru_cache(maxsize=16)
def twiddles(n: int) -> np.ndarray:
    """(n, 2) float32 table of exp(-2πi m/n), built in float64: the line
    engine's twiddles."""
    ang = -2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def twiddles_on(n: int, device: str) -> torch.Tensor:
    """:func:`twiddles` on ``device``, copied once."""
    return torch.from_numpy(twiddles(n)).to(device)


@functools.lru_cache(maxsize=16)
def dct_twiddles(n: int) -> np.ndarray:
    """(2n, 2) float32 table of the DCT solve's steps around a line FFT of
    length n (Makhoul 1980), built in float64 and rounded once: rows k < n
    hold f_k = (c_k/2)·exp(−iπk/2n), the forward step's, and rows n + k
    g_k = exp(iπk/2n)/c_k, the inverse's; c_0 = √(1/n), c_k = √(2/n) the
    orthonormal DCT-II's scales."""
    k = np.arange(n, dtype=np.float64)
    c = np.full(n, np.sqrt(2.0 / n))
    c[0] = np.sqrt(1.0 / n)
    w = np.exp(-1j * np.pi * k / (2 * n))
    tab = np.concatenate([c / 2 * w, np.conj(w) / c])
    return np.stack([tab.real, tab.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def dct_twiddles_on(n: int, device: str) -> torch.Tensor:
    """:func:`dct_twiddles` on ``device``, copied once."""
    return torch.from_numpy(dct_twiddles(n)).to(device)


def raise_on(rc: int, what: str, shape) -> None:
    """Raise for a kernel entry's nonzero return code."""
    if rc == _ERR_SMEM:
        raise ValueError(f"{what}: shape {shape} needs more shared memory "
                         "than a block has")
    if rc == _ERR_SHAPE:
        raise ValueError(f"{what}: shape {shape} has a side longer than "
                         f"{MAX_LINE}, the longest line the kernels take")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} while launching")


def solve_work_floats(batch: int, h: int, w: int, basis: str) -> int:
    """Floats of device scratch one :func:`pocs_solve` call allocates
    (``p3d_pocs_solve_work_floats``): two plane pairs on every basis; one
    partial sum pair per row block of pass (c) on the FFT and DCT bases
    (rows of ``LINE_NT_MAX`` threads, a power-of-two group of at least w/8
    threads a row), per level-0 inverse tile (32×32 samples) on the
    wavelet; and the double-buffered per-slice state."""
    if basis == "wavelet":
        nblk = (-(-w // 32)) ** 2
    else:
        t = 1 << max(0, (-(-w // 8) - 1).bit_length())
        nblk = -(-h // (max(t, _LINE_NT_MAX) // t))
    return 4 * batch * h * w + 2 * batch * nblk + 4 * batch


def _shrink(mag2: torch.Tensor, tau, op: str) -> torch.Tensor:
    """Magnitude-shrink factor, the kernel's threshold: hard keeps
    ``|c| >= tau``; soft shrinks the magnitude by tau; the non-negative
    garrote scales by ``(1 - tau²/|c|²)+`` (pocs_iter.py:80-91)."""
    if op == "soft":
        mag = torch.sqrt(mag2)
        denom = torch.where(mag == 0, torch.ones_like(mag), mag)
        return torch.clamp(1.0 - tau / denom, min=0.0)
    if op == "garrote":
        denom = torch.where(mag2 == 0, torch.ones_like(mag2), mag2)
        return torch.clamp(1.0 - (tau * tau) / denom, min=0.0)
    return (mag2 >= tau * tau).to(mag2.dtype)


def _check_op(thresh_op: str, precision: str) -> str:
    op = "garrote" if thresh_op == "garotte" else thresh_op
    if op not in THRESH_OPS:
        raise ValueError(f"the POCS kernels support {sorted(THRESH_OPS)} "
                         f"thresholds, not {thresh_op!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; choose one of "
                         f"{PRECISIONS}")
    return op


def _check_tensors(named, like: torch.Tensor) -> None:
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, obs on "
                             f"{like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_slices(name: str, z: Cplx) -> tuple[int, int, int]:
    if z.re.dim() != 3 or z.im.shape != z.re.shape:
        raise ValueError(f"{name} must be a (B, H, W) pair, got "
                         f"{tuple(z.re.shape)} / {tuple(z.im.shape)}")
    return tuple(z.re.shape)


def _check(obs: Cplx, mask, decay, thresh_op, version, precision, basis,
           wavelet_mats) -> str:
    op = _check_op(thresh_op, precision)
    if version not in ("regular", "fast"):
        raise ValueError(f"pocs_solve supports regular/fast, not {version!r}")
    if basis not in BASES:
        raise ValueError(f"pocs_solve supports the {BASES} bases, not "
                         f"{basis!r}")
    b, h, w = _check_slices("obs", obs)
    if tuple(mask.shape) != (h, w):
        raise ValueError(f"mask must be ({h}, {w}), got {tuple(mask.shape)}")
    if basis == "wavelet":
        if h != w:
            raise ValueError("the wavelet solve needs square slices")
        if not wavelet_mats:
            raise ValueError("basis='wavelet' needs wavelet_mats (the "
                             "per-level analysis matrices, finest first)")
        level = len(wavelet_mats)
        if h % (1 << level):
            raise ValueError(f"slice side {h} is not divisible by "
                             f"2**{level}")
        for lv, a in enumerate(wavelet_mats):
            if tuple(a.shape) != (h >> lv, h >> lv):
                raise ValueError(f"wavelet_mats[{lv}] must be "
                                 f"({h >> lv}, {h >> lv}), got "
                                 f"{tuple(a.shape)}")
        if decay.dim() != 3 or tuple(decay.shape[1:]) != (b, 3 * level):
            raise ValueError(f"wavelet decay must be (niter, {b}, "
                             f"{3 * level}), got {tuple(decay.shape)}")
        wavelet_taps(wavelet_mats)
    elif decay.dim() != 2 or decay.shape[1] != b:
        raise ValueError(f"decay must be (niter, {b}), got "
                         f"{tuple(decay.shape)}")
    _check_tensors((("obs.re", obs.re), ("obs.im", obs.im), ("mask", mask),
                    ("decay", decay)), obs.re)
    return op


class _SameMatrices:
    """A wavelet matrix set as a cache key: equal only to the same objects
    in the same order (numpy arrays are not hashable). The cache keeps the
    key, hence the matrices, alive, so their ids stay theirs."""

    __slots__ = ("mats",)

    def __init__(self, mats):
        self.mats = tuple(mats)

    def __hash__(self) -> int:
        return hash(tuple(map(id, self.mats)))

    def __eq__(self, other) -> bool:
        return (len(self.mats) == len(other.mats)
                and all(a is b for a, b in zip(self.mats, other.mats)))


@functools.lru_cache(maxsize=16)
def _checked_taps(key: _SameMatrices) -> np.ndarray:
    host = [np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                       else a, dtype=np.float32) for a in key.mats]
    n = host[0].shape[0]
    lo, hi = host[0][0], host[0][n // 2]
    nonzero = np.flatnonzero((lo != 0) | (hi != 0))
    if not nonzero.size:
        raise ValueError("wavelet_mats[0] has no filter in rows 0 and n/2")
    taps = int(nonzero[-1]) + 1
    taps += taps % 2
    deepest = n >> (len(host) - 1)
    if deepest < taps:
        raise ValueError(f"the deepest wavelet block ({deepest}) is shorter "
                         f"than the filter ({taps} taps)")
    for lv, a in enumerate(host):
        if not np.array_equal(a, wv.filter_matrix(lo[:taps], hi[:taps],
                                                  n >> lv)):
            raise ValueError(
                f"wavelet_mats[{lv}] is not the periodized filter matrix of "
                f"the {taps}-tap filters in rows 0 and {n // 2} of "
                "wavelet_mats[0] (ops/wavelet.dwt_matrix)")
    return np.concatenate([lo[:taps], hi[:taps]])


def wavelet_taps(mats) -> np.ndarray:
    """The analysis filters of a wavelet solve's per-level matrices, as the
    kernel takes them: ``[h, g]``, one (2L,) float32 array with L even, h
    from row 0 and g from row n/2 of the level-0 matrix. Raises
    ``ValueError`` when a level's matrix is not the periodized filter matrix
    of those taps (:func:`ops.wavelet.filter_matrix`) or the deepest block
    is shorter than the filter. Each matrix set is checked once, by the
    matrices' identity (the solver passes the cached
    ``ops/wavelet.dwt_matrix_on`` tensors), so a call on the card does not
    wait for the device after the first."""
    return _checked_taps(_SameMatrices(mats))


@functools.lru_cache(maxsize=16)
def _taps_on(key: _SameMatrices, device: str) -> torch.Tensor:
    return torch.from_numpy(_checked_taps(key)).to(device)


def _wavelet_tau_map(tau: torch.Tensor, n: int, level: int) -> torch.Tensor:
    """(B, 3·level) per-band thresholds, deepest level first, each level
    (cH, cV, cD) -> the (B, n, n) per-coefficient map over the Mallat
    quadrant layout (pocs_iter.py:654-666): the level-d detail bands sit
    where max(row, col) is in [s, 2s), s = n >> (level − d); cH has the high
    rows, cV the high columns, cD both. The approximation block gets 0."""
    idx = torch.arange(n, device=tau.device)
    r, c = idx[:, None], idx[None, :]
    band = torch.full((n, n), 3 * level, dtype=torch.int64,
                      device=tau.device)
    for d in range(level):
        s = n >> (level - d)
        hi_r, hi_c = (r >= s) & (r < 2 * s), (c >= s) & (c < 2 * s)
        lo_r, lo_c = r < s, c < s
        band = torch.where(hi_r & lo_c, 3 * d, band)
        band = torch.where(lo_r & hi_c, 3 * d + 1, band)
        band = torch.where(hi_r & hi_c, 3 * d + 2, band)
    padded = torch.cat([tau, torch.zeros_like(tau[:, :1])], dim=-1)
    return padded[:, band]


def _real_pair(fn):
    """A real linear map applied to re and im of a complex tensor."""
    return lambda y: torch.complex(fn(y.real.contiguous()),
                                   fn(y.imag.contiguous()))


def _plain_basis(basis: str, h: int, w: int, device, wavelet_mats):
    """(forward, inverse, tau_of) of a basis on (B, H, W) complex tensors:
    the kernels' products in the JAX kernel's association order, the
    inverse with its scale; ``tau_of`` maps one iteration's decay row to
    thresholds that broadcast against the coefficients."""
    if basis == "fft":
        return (torch.fft.fft2, torch.fft.ifft2,
                lambda t: t[:, None, None])
    if basis == "dct":
        ch, cht = dft.dct_on(h, str(device))
        cw, cwt = dft.dct_on(w, str(device))
        return (_real_pair(lambda y: (ch @ y) @ cwt),
                _real_pair(lambda x: (cht @ x) @ cw),
                lambda t: t[:, None, None])
    mats = [torch.as_tensor(np.asarray(a), device=device)
            if not isinstance(a, torch.Tensor) else a.to(device)
            for a in wavelet_mats]

    def fwd(y):
        y = y.clone()
        for lv, a in enumerate(mats):
            nj = h >> lv
            y[..., :nj, :nj] = (a @ y[..., :nj, :nj]) @ a.T
        return y

    def inv(x):
        x = x.clone()
        for lv in range(len(mats) - 1, -1, -1):
            nj = h >> lv
            x[..., :nj, :nj] = (mats[lv].T @ x[..., :nj, :nj]) @ mats[lv]
        return x

    return (_real_pair(fwd), _real_pair(inv),
            lambda t: _wavelet_tau_map(t, h, len(mats)))


def pocs_solve_plain(obs: Cplx, mask: torch.Tensor, decay: torch.Tensor,
                     alpha: float = 0.75, thresh_op: str = "hard",
                     version: str = "fast", basis: str = "fft",
                     wavelet_mats=None) -> tuple[Cplx, torch.Tensor]:
    """The solve in plain PyTorch (``torch.fft`` for the FFT basis, dense
    ``torch.matmul`` products for the DCT and wavelet bases, complex64):
    the same function as the kernel, from the same initial state
    ``x_prev = x = obs, v = 1, cost_prev = +inf``. Returns the final
    iterate and the final-iteration cost per slice."""
    op = "garrote" if thresh_op == "garotte" else thresh_op
    fast = version == "fast"
    z0 = torch.complex(obs.re, obs.im)
    b, h, w = z0.shape
    forward, inverse, tau_of = _plain_basis(basis, h, w, z0.device,
                                            wavelet_mats)
    keep = 1.0 - alpha * mask
    a_obs = alpha * z0
    x = x_prev = z0
    v = torch.ones(b, dtype=torch.float32, device=z0.device)
    cost = cost_prev = torch.full((b,), float("inf"), device=z0.device)
    for j in range(decay.shape[0]):
        v1 = (1.0 + torch.sqrt(1.0 + 4.0 * v * v)) / 2.0
        f = (v - 1.0) / (v1 + 1.0) if fast else torch.zeros_like(v)
        y = x + f[:, None, None] * (x - x_prev)
        spec = forward(y)
        spec = spec * _shrink(spec.real ** 2 + spec.imag ** 2,
                              tau_of(decay[j]), op)
        new = inverse(spec) * keep + a_obs
        mag_new = new.abs()
        d = torch.sum(mag_new - x.abs(), dim=(-2, -1))
        s = torch.sum(mag_new, dim=(-2, -1))
        cost = (d * d) / torch.where(s == 0, torch.ones_like(s), s * s)
        if fast:
            restart = cost > cost_prev
            x_prev = torch.where(restart[:, None, None], new, x)
            v = torch.where(restart, torch.ones_like(v1), v1)
        else:
            x_prev, v = x, v1
        x, cost_prev = new, cost
    return Cplx(x.real.contiguous(), x.imag.contiguous()), cost


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pocs_solve")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.p3d_pocs_solve_work_floats.argtypes = [i, i, i, i]
    lib.p3d_pocs_iteration_work_floats.argtypes = [i, i, i]
    for name in ("p3d_pocs_solve_work_floats",
                 "p3d_pocs_iteration_work_floats"):
        getattr(lib, name).restype = ctypes.c_size_t
    lib.p3d_pocs_solve.argtypes = [p] * 10 + [i] * 4 + [f, i, i, p]
    lib.p3d_pocs_solve_dct.argtypes = [p] * 12 + [i] * 4 + [f, i, i, p]
    lib.p3d_pocs_solve_wavelet.argtypes = ([p] * 5 + [i] + [p] * 4 + [i] * 4
                                           + [f, i, i, p])
    lib.p3d_pocs_iteration.argtypes = [p] * 11 + [i] * 3 + [f, i, p]
    for name in ("p3d_pocs_solve", "p3d_pocs_solve_dct",
                 "p3d_pocs_solve_wavelet", "p3d_pocs_iteration"):
        getattr(lib, name).restype = i
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pocs_solve(obs: Cplx, mask: torch.Tensor, decay: torch.Tensor,
               alpha: float = 0.75, thresh_op: str = "hard",
               version: str = "fast", precision: str = "highest",
               basis: str = "fft", wavelet_mats=None,
               ) -> tuple[Cplx, torch.Tensor]:
    """The complete fixed-iteration POCS solve of a batch of slices.

    ``obs``: (B, H, W) float32 pair, any H and W (square for the wavelet
    basis); ``mask``: (H, W); ``decay``: (niter, B) per-iteration
    per-slice thresholds, or for ``basis='wavelet'`` (niter, B, 3·level)
    per-band thresholds, deepest level first, each level (cH, cV, cD);
    ``version``: 'regular' or 'fast' (Nesterov with adaptive restart);
    ``precision``: 'high', 'highest' or 'default', all computed in full
    fp32;
    ``basis``: 'fft', 'dct' (orthonormal DCT-II), both with H and W up to
    4096 on the card (a longer side raises ``ValueError``; the JAX kernel
    takes only sides of a multiple of 128 that fit its VMEM, all of them
    shorter), or 'wavelet' (the Mallat cascade of ``wavelet_mats``, the
    per-level analysis matrices ``ops/wavelet.dwt_matrix(n >> lv, name)``,
    finest first; the card runs their filters, :func:`wavelet_taps`).
    Returns ``(result, final_cost)``. CUDA tensors run the CUDA kernel,
    CPU tensors :func:`pocs_solve_plain`.
    """
    op = _check(obs, mask, decay, thresh_op, version, precision, basis,
                wavelet_mats)
    device = obs.re.device
    b, h, w = obs.re.shape
    if b and device.type == "cpu":
        return pocs_solve_plain(obs, mask, decay, alpha, op, version, basis,
                                wavelet_mats)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"pocs_solve runs on cuda or cpu tensors, not "
                         f"{device}")
    out_re = torch.empty_like(obs.re)
    out_im = torch.empty_like(obs.im)
    cost = torch.empty(b, dtype=torch.float32, device=device)
    if b == 0:
        return Cplx(out_re, out_im), cost
    lib = _lib()
    work = torch.empty(lib.p3d_pocs_solve_work_floats(b, h, w,
                                                      BASES.index(basis)),
                       dtype=torch.float32, device=device)
    head = (obs.re.data_ptr(), obs.im.data_ptr(), mask.data_ptr(),
            decay.data_ptr())
    tail = (out_re.data_ptr(), out_im.data_ptr(), cost.data_ptr(),
            work.data_ptr())
    common = (decay.shape[0], float(alpha), THRESH_OPS[op],
              int(version == "fast"), _stream(device))
    with torch.cuda.device(device):
        if basis == "fft":
            rc = lib.p3d_pocs_solve(
                *head, twiddles_on(h, str(device)).data_ptr(),
                twiddles_on(w, str(device)).data_ptr(), *tail, b, h, w,
                *common)
        elif basis == "dct":
            rc = lib.p3d_pocs_solve_dct(
                *head, twiddles_on(h, str(device)).data_ptr(),
                twiddles_on(w, str(device)).data_ptr(),
                dct_twiddles_on(h, str(device)).data_ptr(),
                dct_twiddles_on(w, str(device)).data_ptr(), *tail, b, h, w,
                *common)
        else:
            taps = _taps_on(_SameMatrices(wavelet_mats), str(device))
            rc = lib.p3d_pocs_solve_wavelet(
                *head, taps.data_ptr(), taps.numel() // 2, *tail, b, h,
                len(wavelet_mats), *common)
    raise_on(rc, f"pocs_solve[{basis}]", (b, h, w))
    pocs_solve.launches_by_basis[basis] += 1
    return Cplx(out_re, out_im), cost


pocs_solve.launches_by_basis = dict.fromkeys(BASES, 0)


def pocs_iteration_plain(x: Cplx, obs: Cplx, mask: torch.Tensor,
                         tau: torch.Tensor, alpha: float = 1.0,
                         thresh_op: str = "hard") -> Cplx:
    """One FFT-basis POCS iteration in plain PyTorch (``torch.fft``):
    ``ifft2(shrink(fft2(x), tau[b])) · (1 − α·mask) + α·obs``."""
    op = "garrote" if thresh_op == "garotte" else thresh_op
    spec = torch.fft.fft2(torch.complex(x.re, x.im))
    spec = spec * _shrink(spec.real ** 2 + spec.imag ** 2,
                          tau[:, None, None], op)
    rec = torch.fft.ifft2(spec)
    keep = 1.0 - alpha * mask
    return Cplx((rec.real * keep + alpha * obs.re).contiguous(),
                (rec.imag * keep + alpha * obs.im).contiguous())


def pocs_iteration(x: Cplx, obs: Cplx, mask: torch.Tensor, tau: torch.Tensor,
                   alpha: float = 1.0, thresh_op: str = "hard",
                   precision: str = "highest") -> Cplx:
    """One fused FFT-basis POCS iteration over a batch of slices, the
    contract of the JAX package's ``pocs_iteration_fused``.

    ``x``/``obs``: (B, H, W) float32 pairs, H and W up to 4096 on the card
    (any on the CPU); ``mask``: (H, W);
    ``tau``: (B,) per-slice thresholds; ``precision``: 'high', 'highest' or
    'default', all full fp32. Returns the reinserted iterate (B, H, W). CUDA tensors
    run the CUDA kernel, CPU tensors :func:`pocs_iteration_plain`.
    """
    op = _check_op(thresh_op, precision)
    b, h, w = _check_slices("x", x)
    if _check_slices("obs", obs) != (b, h, w):
        raise ValueError(f"obs {tuple(obs.re.shape)} does not match x "
                         f"{(b, h, w)}")
    if tuple(mask.shape) != (h, w):
        raise ValueError(f"mask must be ({h}, {w}), got {tuple(mask.shape)}")
    if tuple(tau.shape) != (b,):
        raise ValueError(f"tau must be ({b},), got {tuple(tau.shape)}")
    _check_tensors((("x.re", x.re), ("x.im", x.im), ("obs.re", obs.re),
                    ("obs.im", obs.im), ("mask", mask), ("tau", tau)), x.re)
    device = x.re.device
    if b and device.type == "cpu":
        return pocs_iteration_plain(x, obs, mask, tau, alpha, op)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"pocs_iteration runs on cuda or cpu tensors, not "
                         f"{device}")
    out = Cplx(torch.empty_like(x.re), torch.empty_like(x.im))
    if b == 0:
        return out
    lib = _lib()
    work = torch.empty(lib.p3d_pocs_iteration_work_floats(b, h, w),
                       dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.p3d_pocs_iteration(
            x.re.data_ptr(), x.im.data_ptr(), obs.re.data_ptr(),
            obs.im.data_ptr(), mask.data_ptr(), tau.data_ptr(),
            twiddles_on(h, str(device)).data_ptr(),
            twiddles_on(w, str(device)).data_ptr(), out.re.data_ptr(),
            out.im.data_ptr(), work.data_ptr(), b, h, w, float(alpha),
            THRESH_OPS[op], _stream(device))
    raise_on(rc, "pocs_iteration", (b, h, w))
    pocs_iteration.launches += 1
    return out


pocs_iteration.launches = 0


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    pocs_solve.launches_by_basis = dict.fromkeys(BASES, 0)
    pocs_iteration.launches = 0
