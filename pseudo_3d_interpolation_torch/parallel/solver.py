"""Cube drivers: solve every slice of a (F, H, W) cube on one device.

Counterpart of ``pseudo_3d_interpolation_tpu/parallel/solver.py``.
:func:`interpolate_cube_resident` uploads the cube once, solves it batch by
batch on the device and downloads the result once;
:func:`interpolate_cube` moves one batch at a time, for cubes that do not
fit the device. Both run eagerly, so a short last batch needs no zero
padding (the JAX drivers padded it to keep one compiled program). The
JAX package's ``mesh`` sharding is not ported yet (ROADMAP queue 1 #14).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pocs import POCSConfig, pocs_interpolate
from ..models.transforms import get_transform
from ..ops.cplx import Cplx, from_complex, to_complex


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the first CUDA device when there is one,
    else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def fits_resident(device, n_slices: int, batch: int, h: int, w: int) -> bool:
    """Whether :func:`interpolate_cube_resident` fits in ``device``'s free
    memory. Its peak is two cube-sized float32 pairs (the input and the
    result; the complex staging copy of the upload and of the download
    replaces one of them while it lives) and one batch's solve buffers
    (the kernel's work, its output and the decay's spectrum: about six
    pairs per slice). The rule asks for three cubes and eight batches. A
    CPU "device" is the host memory that already holds the cube: it always
    fits."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(
        device)
    return (3 * n_slices + 8 * batch) * h * w * 8 <= free


def _to_host(rec: Cplx, was_complex: bool) -> np.ndarray:
    return to_complex(rec) if was_complex else rec.re.cpu().numpy()


def _empty(data: np.ndarray, was_complex: bool):
    return (np.empty(data.shape, np.complex64 if was_complex else np.float32),
            np.empty((0,), np.int32), np.empty((0,), np.float32))


def interpolate_cube_resident(data, mask, config: POCSConfig = POCSConfig(),
                              transform=None, batch: int = 8, progress=None,
                              device=None):
    """Device-resident cube driver: one upload, per-batch solves on the
    device, one download.

    ``data``: (F, H, W) complex64 or float32 numpy array; ``mask``: (H, W)
    shared sampling mask; ``progress``: optional ``callable(done, total)``.
    Returns numpy ``(recon, n_iterations, cost)``: (F, H, W), (F,), (F,).
    """
    if transform is None:
        transform = get_transform(config.transform_kind)
    device = resolve_device(device)
    data = np.asarray(data)
    was_complex = np.iscomplexobj(data)
    f_total = data.shape[0]
    if f_total == 0:
        return _empty(data, was_complex)
    z = from_complex(data, device)
    m = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    rec = Cplx(torch.empty_like(z.re), torch.empty_like(z.im))
    iters = torch.empty(f_total, dtype=torch.int32, device=device)
    cost = torch.empty(f_total, dtype=torch.float32, device=device)
    batch = max(1, min(batch, f_total))
    for start in range(0, f_total, batch):
        stop = min(start + batch, f_total)
        res = pocs_interpolate(Cplx(z.re[start:stop], z.im[start:stop]), m,
                               transform, config)
        rec.re[start:stop] = res.data.re
        rec.im[start:stop] = res.data.im
        iters[start:stop] = res.n_iterations
        cost[start:stop] = res.cost
        if progress is not None:
            progress(stop, f_total)
    del z  # the download's staging copy takes its place
    return (_to_host(rec, was_complex), iters.cpu().numpy(),
            cost.cpu().numpy())


def interpolate_cube(data, mask, config: POCSConfig = POCSConfig(),
                     transform=None, batch: int = 128, progress=None,
                     device=None):
    """Host-chunked cube driver: each batch of slices goes to the device,
    is solved and comes back before the next. Same arguments and returns
    as :func:`interpolate_cube_resident`."""
    if transform is None:
        transform = get_transform(config.transform_kind)
    device = resolve_device(device)
    data = np.asarray(data)
    was_complex = np.iscomplexobj(data)
    f_total = data.shape[0]
    if f_total == 0:
        return _empty(data, was_complex)
    out = np.empty(data.shape, np.complex64 if was_complex else np.float32)
    n_iters = np.empty((f_total,), np.int32)
    costs = np.empty((f_total,), np.float32)
    m = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    batch = max(1, min(batch, f_total))
    for start in range(0, f_total, batch):
        stop = min(start + batch, f_total)
        res = pocs_interpolate(from_complex(data[start:stop], device), m,
                               transform, config)
        out[start:stop] = _to_host(res.data, was_complex)
        n_iters[start:stop] = res.n_iterations.cpu().numpy()
        costs[start:stop] = res.cost.cpu().numpy()
        if progress is not None:
            progress(stop, f_total)
    return out, n_iters, costs
