"""Complex slices as (re, im) pairs of float32 tensors.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/cplx.py``.

Representation choice: the public functions of this package take and return
``Cplx(re, im)`` pairs, batch first ``(B, H, W)``, exactly like the JAX
package, so the parity tests compare like with like and the CUDA kernels get
plain float32 planes. Inside a plain PyTorch version (never inside a kernel)
native ``torch.complex64`` is allowed where it is the clearer idiom, e.g.
around ``torch.fft``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Cplx(NamedTuple):
    """A complex tensor as a (real, imag) pair of equal-shaped float tensors."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def conj(self) -> "Cplx":
        return Cplx(self.re, -self.im)

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.re * self.re + self.im * self.im)

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im


def from_complex(z, device=None) -> Cplx:
    """numpy/torch (complex or real) array -> contiguous float32 ``Cplx``.

    With a ``device``, a numpy array crosses in its storage order: a dense
    view such as a cube with its last axis moved to the front is one copy,
    and the split into planes and the axis permutation run on the device.
    """
    if (device is not None and isinstance(z, np.ndarray)
            and z.flags.writeable and min(z.strides, default=0) >= 0):
        z = torch.from_numpy(z).to(device)
    if isinstance(z, torch.Tensor):
        if z.is_complex():
            re, im = z.real, z.imag
        else:
            re, im = z, torch.zeros_like(z)
        re = re.to(device=device, dtype=torch.float32).contiguous()
        im = im.to(device=device, dtype=torch.float32).contiguous()
        return Cplx(re, im)
    z = np.asarray(z)
    if np.iscomplexobj(z):
        re = np.ascontiguousarray(z.real, np.float32)
        im = np.ascontiguousarray(z.imag, np.float32)
    else:
        re = np.ascontiguousarray(z, np.float32)
        im = np.zeros_like(re)
    re, im = torch.from_numpy(re), torch.from_numpy(im)
    if device is not None:
        re, im = re.to(device), im.to(device)
    return Cplx(re, im)


def to_complex(z: Cplx) -> np.ndarray:
    """``Cplx`` pair -> numpy complex64 on the host (interleaved on the
    pair's device, then one copy)."""
    return torch.complex(z.re.detach().float(),
                         z.im.detach().float()).cpu().numpy()


def zeros(shape, dtype=torch.float32, device=None) -> Cplx:
    """A pair of zero tensors of ``shape`` on ``device``."""
    return Cplx(torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


def where(cond, a: Cplx, b: Cplx) -> Cplx:
    """``a`` where ``cond`` holds, else ``b``, part by part."""
    return Cplx(torch.where(cond, a.re, b.re), torch.where(cond, a.im, b.im))
