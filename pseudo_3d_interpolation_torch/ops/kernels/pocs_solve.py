"""Fixed-iteration POCS solve, FFT basis: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``pseudo_3d_interpolation_tpu/ops/pallas/pocs_iter.py ::
pocs_solve_fused`` with ``basis='fft'`` (kernel body ``_solve_kernel``),
which runs the whole solve of each slice in one Pallas launch with the
slice held in VMEM. That cannot carry over: a 512² complex slice is 2 MB
and a Hopper block has at most 227 KB of shared memory.
``csrc/pocs_solve.cu`` instead enqueues, per iteration, four batched complex
DFT products over the whole batch (threshold fused into the forward
right-product, scale, reinsertion and the cost's partial sums fused into the
inverse right-product) and one per-slice state kernel that takes the FPOCS
restart decision on the device. It is bound by the dense DFT products,
16·H·W·(H+W) fp32 flops per slice-iteration on the CUDA cores; the file's
header has the details.

:func:`pocs_solve` launches the kernel for CUDA tensors and takes
:func:`pocs_solve_plain` only for CPU tensors; ``pocs_solve.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import dft
from ..cplx import Cplx
from . import _build

THRESH_OPS = {"hard": 0, "soft": 1, "garrote": 2}
PRECISIONS = ("high", "highest")


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


def _check(obs: Cplx, mask, decay, thresh_op, version, precision) -> str:
    op = "garrote" if thresh_op == "garotte" else thresh_op
    if op not in THRESH_OPS:
        raise ValueError(f"pocs_solve supports {sorted(THRESH_OPS)} "
                         f"thresholds, not {thresh_op!r}")
    if version not in ("regular", "fast"):
        raise ValueError(f"pocs_solve supports regular/fast, not {version!r}")
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r}: the solve computes 'high' and "
            "'highest' in full fp32; a Hopper mapping of the other modes "
            "(TF32, 3xTF32, bf16) is an open ROADMAP item")
    if obs.re.dim() != 3 or obs.im.shape != obs.re.shape:
        raise ValueError(f"obs must be a (B, H, W) pair, got "
                         f"{tuple(obs.re.shape)} / {tuple(obs.im.shape)}")
    b, h, w = obs.re.shape
    if tuple(mask.shape) != (h, w):
        raise ValueError(f"mask must be ({h}, {w}), got {tuple(mask.shape)}")
    if decay.dim() != 2 or decay.shape[1] != b:
        raise ValueError(f"decay must be (niter, {b}), got "
                         f"{tuple(decay.shape)}")
    for name, t in (("obs.re", obs.re), ("obs.im", obs.im), ("mask", mask),
                    ("decay", decay)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != obs.re.device:
            raise ValueError(f"{name} is on {t.device}, obs on "
                             f"{obs.re.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return op


def pocs_solve_plain(obs: Cplx, mask: torch.Tensor, decay: torch.Tensor,
                     alpha: float = 0.75, thresh_op: str = "hard",
                     version: str = "fast") -> tuple[Cplx, torch.Tensor]:
    """The solve in plain PyTorch (``torch.fft``, complex64): the same
    function as the kernel, from the same initial state
    ``x_prev = x = obs, v = 1, cost_prev = +inf``. Returns the final
    iterate and the final-iteration cost per slice."""
    op = "garrote" if thresh_op == "garotte" else thresh_op
    fast = version == "fast"
    z0 = torch.complex(obs.re, obs.im)
    keep = 1.0 - alpha * mask
    a_obs = alpha * z0
    b = z0.shape[0]
    x = x_prev = z0
    v = torch.ones(b, dtype=torch.float32, device=z0.device)
    cost = cost_prev = torch.full((b,), float("inf"), device=z0.device)
    for j in range(decay.shape[0]):
        v1 = (1.0 + torch.sqrt(1.0 + 4.0 * v * v)) / 2.0
        f = (v - 1.0) / (v1 + 1.0) if fast else torch.zeros_like(v)
        y = x + f[:, None, None] * (x - x_prev)
        spec = torch.fft.fft2(y)
        spec = spec * _shrink(spec.real ** 2 + spec.imag ** 2,
                              decay[j][:, None, None], op)
        new = torch.fft.ifft2(spec) * keep + a_obs
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
    lib = _build.load()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.p3d_pocs_solve_work_floats.argtypes = [i, i, i]
    lib.p3d_pocs_solve_work_floats.restype = ctypes.c_size_t
    lib.p3d_pocs_solve.argtypes = [p] * 12 + [i] * 4 + [f, i, i, p]
    lib.p3d_pocs_solve.restype = i
    return lib


@functools.lru_cache(maxsize=8)
def _dft_on(n: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    fr, fi = dft.dft_matrices(n)
    return (torch.from_numpy(fr).to(device), torch.from_numpy(fi).to(device))


def pocs_solve(obs: Cplx, mask: torch.Tensor, decay: torch.Tensor,
               alpha: float = 0.75, thresh_op: str = "hard",
               version: str = "fast", precision: str = "highest",
               ) -> tuple[Cplx, torch.Tensor]:
    """The complete fixed-iteration POCS solve of a batch of slices.

    ``obs``: (B, H, W) float32 pair, any H and W; ``mask``: (H, W);
    ``decay``: (niter, B) per-iteration per-slice thresholds;
    ``version``: 'regular' or 'fast' (Nesterov with adaptive restart);
    ``precision``: 'high' or 'highest', both computed in full fp32.
    Returns ``(result, final_cost)``. CUDA tensors run the CUDA kernel,
    CPU tensors :func:`pocs_solve_plain`.
    """
    op = _check(obs, mask, decay, thresh_op, version, precision)
    device = obs.re.device
    if device.type == "cpu":
        return pocs_solve_plain(obs, mask, decay, alpha, op, version)
    if device.type != "cuda":
        raise ValueError(f"pocs_solve runs on cuda or cpu tensors, not "
                         f"{device}")
    b, h, w = obs.re.shape
    out_re = torch.empty_like(obs.re)
    out_im = torch.empty_like(obs.im)
    cost = torch.empty(b, dtype=torch.float32, device=device)
    if b == 0:
        return Cplx(out_re, out_im), cost
    lib = _lib()
    work = torch.empty(lib.p3d_pocs_solve_work_floats(b, h, w),
                       dtype=torch.float32, device=device)
    fh = _dft_on(h, str(device))
    fw = _dft_on(w, str(device))
    with torch.cuda.device(device):
        rc = lib.p3d_pocs_solve(
            obs.re.data_ptr(), obs.im.data_ptr(), mask.data_ptr(),
            decay.data_ptr(), fh[0].data_ptr(), fh[1].data_ptr(),
            fw[0].data_ptr(), fw[1].data_ptr(), out_re.data_ptr(),
            out_im.data_ptr(), cost.data_ptr(), work.data_ptr(),
            b, h, w, decay.shape[0], float(alpha), THRESH_OPS[op],
            int(version == "fast"),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pocs_solve: CUDA error {rc} while launching")
    pocs_solve.launches += 1
    return Cplx(out_re, out_im), cost


pocs_solve.launches = 0
