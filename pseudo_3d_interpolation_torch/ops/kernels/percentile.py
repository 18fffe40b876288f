"""Per-band percentile thresholds of the spectral-stack POCS iteration: the
CUDA selection kernel's wrapper and its plain PyTorch version.

:func:`band_percentile` takes one percentile of each segment of keys (one
band's ``|c|`` over a slice's H·W, written by the subband kernels' pass 1:
``subband.subband_keys`` and ``subband.box_keys``) and returns the
thresholds their pass 2 shrinks with. It replaces no TPU kernel: the JAX
package takes this percentile in XLA
(``pseudo_3d_interpolation_tpu/ops/threshold.py :: _percentile_from_mag``)
inside its plain streamed apply. The kernel (``csrc/band_percentile.cu``)
is an exact radix select on the keys' bits, bit-equal to
:func:`band_percentile_plain`, which is ``ops/threshold._percentile_from_mag``
on the same keys. It starts from the histogram of the keys' first digit
(:func:`key_histogram_plain`'s layout), which pass 1 counts as it writes
the keys, and reads the keys once more: the keys of the bin that holds the
rank go to a candidate buffer (:func:`candidate_capacity` a segment), and
one block a segment finishes the select on them. CUDA tensors run the
kernel, CPU tensors the plain version; a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..threshold import _percentile_from_mag
from . import _build
from .pocs_solve import raise_on

KEY_BINS = 2048  # values of the first digit: the order key's bits 21-31
HIST_COLS = KEY_BINS + 1  # a segment's histogram: the bins, then its NaNs
STATE_WORDS = 8  # the kernel's per-segment state, int32 words


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("band_percentile")
    p = ctypes.c_void_p
    lib.p3d_band_percentile.argtypes = [p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_longlong, p]
    lib.p3d_band_percentile.restype = ctypes.c_int
    return lib


def order_keys(keys: torch.Tensor) -> torch.Tensor:
    """The kernels' order keys of float32 ``keys``, held in int64: a float's
    bits with the sign bit set when it is non-negative, flipped when it is
    negative, so that they order as the floats do."""
    u = keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)


def key_histogram_plain(keys: torch.Tensor) -> torch.Tensor:
    """The histogram pass 1 counts beside the keys: for each (H, W) segment
    of ``keys`` (..., H, W), the counts of the KEY_BINS values of its keys'
    first digit (the order key's top 11 bits), NaNs included, then the
    count of its NaNs: (..., HIST_COLS) int32."""
    lead = tuple(keys.shape[:-2])
    flat = keys.reshape(-1, keys.shape[-2] * keys.shape[-1])
    digit = order_keys(flat) >> 21
    segs = flat.shape[0]
    rows = torch.arange(segs, device=keys.device)[:, None] * KEY_BINS
    hist = torch.bincount((rows + digit).reshape(-1),
                          minlength=segs * KEY_BINS).reshape(segs, KEY_BINS)
    nans = torch.isnan(flat).sum(dim=-1, keepdim=True)
    return torch.cat([hist, nans], dim=-1).to(torch.int32).reshape(
        lead + (HIST_COLS,))


def candidate_capacity(n: int) -> int:
    """Keys the kernel's candidate buffer holds for a segment of ``n``: half
    of it, rounded up to a multiple of 4 (16-byte loads). On the 512²
    SHEARLET and CURVELET bands of plane waves the bin that holds the rank
    keeps about a tenth of a segment on average and nearly all of it at
    most, so nearly every segment fits at 2 bytes a key (``chip_smoke.py``
    phase 17a prints the shares); a segment whose bin holds more is
    finished over its keys."""
    return ((n + 1) // 2 + 3) // 4 * 4


def select_bytes(segments: int, n: int) -> int:
    """Device bytes one :func:`band_percentile` call on ``segments``
    segments of ``n`` keys allocates beyond its result: the candidates and
    the per-segment state (the histogram comes with the keys)."""
    return 4 * segments * (candidate_capacity(n) + STATE_WORDS)


def band_percentile_plain(keys: torch.Tensor, q: torch.Tensor
                          ) -> torch.Tensor:
    """``_percentile_from_mag`` of each (H, W) segment of ``keys``
    (..., H, W) at its percentile ``q`` (...): a sort of each segment and
    jnp.percentile's linear rule."""
    return _percentile_from_mag(keys, q)[..., 0, 0]


def band_percentile(keys: torch.Tensor, q: torch.Tensor,
                    hist: torch.Tensor | None = None) -> torch.Tensor:
    """The percentile ``q[i]`` (in percent) of the H·W keys of each segment
    ``keys[i]``: ``keys`` (..., H, W) float32, each segment one contiguous
    block of H·W (contiguous, or the transposed view ``subband_keys``
    returns), ``q`` (...) float32 contiguous, on one device. On the card
    ``hist`` (..., HIST_COLS) int32 is the keys' first-digit histogram
    (pass 1's, or :func:`key_histogram_plain`'s); CPU tensors need none.
    Returns the (...) thresholds, bit-equal on the card to
    :func:`band_percentile_plain` on the same keys (which CPU tensors run).
    The kernel sorts nothing: it takes the rank's bin from ``hist``, reads
    the keys once for that bin's keys, and finishes on them."""
    lead = tuple(keys.shape[:-2])
    if keys.dim() < 2 or tuple(q.shape) != lead:
        raise ValueError(f"keys must be (..., H, W) and q its (...), got "
                         f"{tuple(keys.shape)} / {tuple(q.shape)}")
    segments_packed = (keys.is_contiguous()
                       or keys.transpose(-1, -2).is_contiguous())
    for name, t, ok in (("keys", keys, segments_packed),
                        ("q", q, q.is_contiguous())):
        if t.dtype != torch.float32 or not ok:
            raise ValueError(f"{name} must be float32, each segment "
                             "contiguous")
        if t.device != keys.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} is on {t.device}; keys and q must "
                             "share one cuda or cpu device")
    n = keys.shape[-2] * keys.shape[-1]
    if n == 0:
        raise ValueError("band_percentile of empty segments")
    if keys.device.type == "cpu":
        return band_percentile_plain(keys, q)
    if (hist is None or hist.dtype != torch.int32 or hist.device != keys.device
            or tuple(hist.shape) != lead + (HIST_COLS,)
            or not hist.is_contiguous()):
        raise ValueError(f"on the card band_percentile needs hist, the keys' "
                         f"first-digit histogram {lead + (HIST_COLS,)} int32 "
                         f"on {keys.device} (pass 1's, or "
                         "key_histogram_plain's)")
    segments = q.numel()
    cap = candidate_capacity(n)
    t = torch.empty_like(q)
    state = torch.empty(segments * STATE_WORDS, dtype=torch.int32,
                        device=keys.device)
    cand = torch.empty(max(1, segments * cap), dtype=torch.int32,
                       device=keys.device)
    # n − 1 rounded as float32, as the plain version (and JAX) computes it
    top = float(np.float32(n) - np.float32(1))
    with torch.cuda.device(keys.device):
        rc = _lib().p3d_band_percentile(
            keys.data_ptr(), q.data_ptr(), hist.data_ptr(), t.data_ptr(),
            state.data_ptr(), cand.data_ptr(), segments, n, top, cap,
            torch.cuda.current_stream(keys.device).cuda_stream)
    raise_on(rc, "band_percentile", tuple(keys.shape))
    band_percentile.launches += 1
    return t


band_percentile.launches = 0
