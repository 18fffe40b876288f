"""Array padding and de-padding helpers, and the cube drivers' tile
padding (``POCSConfig.pad_to_tile``).

Counterpart of ``pseudo_3d_interpolation_tpu/utils/pad.py``. The array
helpers take and return tensors (numpy input goes to the CPU); the tile
helpers are host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def pad_mirror_flip(a, n: int, zeros: bool = False) -> torch.Tensor:
    """Pad a 1-D array with ``n`` values on each side: the signal mirrored
    and flipped about the edge value (odd-symmetric extension, the
    reference's ``pad_array``), or zeros with ``zeros=True``."""
    a = _tensor(a)
    if n <= 0:
        return a
    if zeros:
        z = torch.zeros(n, dtype=a.dtype, device=a.device)
        return torch.cat([z, a, z])
    start = a[0] - (a[1:n + 1].flip(0) - a[0]).abs()
    end = a[-1] - (a[-n - 1:-1].flip(0) - a[-1]).abs()
    return torch.cat([start, a, end])


def pad_along_axis(array, n, mode: str = "constant", axis: int = -1,
                   **kwargs) -> torch.Tensor:
    """Pad an N-D array along one axis by ``n`` (or ``(before, after)``)
    with ``numpy.pad``'s ``mode``: 'constant' (``constant_values``),
    'edge', 'reflect', 'symmetric' or 'wrap'."""
    array = _tensor(array)
    if isinstance(n, (tuple, list)):
        n_before, n_after = int(n[0]), int(n[1])
    else:
        n_before = n_after = int(n)
    n_before, n_after = max(n_before, 0), max(n_after, 0)
    if n_before == 0 and n_after == 0:
        return array
    axis = axis % array.ndim
    if mode == "constant":
        value = kwargs.get("constant_values", 0)
        shape = list(array.shape)

        def fill(k):
            shape[axis] = k
            return torch.full(shape, value, dtype=array.dtype,
                              device=array.device)
        return torch.cat([fill(n_before), array, fill(n_after)], dim=axis)
    if kwargs:
        raise TypeError(f"mode {mode!r} takes no options, got "
                        f"{sorted(kwargs)}")
    # the index-only modes: numpy.pad of the positions gives the gather
    idx = np.pad(np.arange(array.shape[axis]), (n_before, n_after),
                 mode=mode)
    return array.index_select(axis, torch.from_numpy(idx).to(array.device))


def pad_to_shape(array, shape, mode: str = "constant",
                 **kwargs) -> torch.Tensor:
    """Pad an array at the end of each axis up to ``shape``."""
    array = _tensor(array)
    npad = [int(t) - int(s) for s, t in zip(array.shape, shape)]
    if any(p < 0 for p in npad):
        raise ValueError(f"target shape {tuple(shape)} smaller than array "
                         f"shape {tuple(array.shape)}")
    for axis, p in enumerate(npad):
        if p:
            array = pad_along_axis(array, (0, p), mode, axis, **kwargs)
    return array


def slice_valid_data(data, nso: int):
    """Undo zero padding: the ``nso`` valid samples of each trace of a
    (samples, traces) block whose traces were zero-padded top and/or
    bottom, and each trace's start index."""
    data = _tensor(data)
    idx_start = (data != 0).to(torch.int8).argmax(dim=0)
    indexer = (torch.arange(nso, device=data.device)[:, None]
               + idx_start[None, :])
    return torch.take_along_dim(data, indexer, dim=0), idx_start


def next_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return int(-(-int(n) // int(m)) * int(m))


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n``."""
    return 1 << int(np.ceil(np.log2(max(int(n), 1))))


# the JAX package's engage threshold of its automatic policy, measured on
# its TPU kernels; here the policy never engages (auto_pad_to_tile)
PAD_TO_TILE_MAX_AREA = 1.3


def pad_area_ratio(h: int, w: int, multiple: int = 128) -> float:
    """Tile padding's compute overhead: padded area / raw area."""
    return (next_multiple(h, multiple) * next_multiple(w, multiple)
            / float(int(h) * int(w)))


def auto_pad_to_tile(config, h: int, w: int, transform=None,
                     multiple: int = 128) -> bool:
    """Resolve a POCSConfig's tri-state ``pad_to_tile`` for an (h, w)
    grid. ``True`` and ``False`` are explicit overrides. ``None`` (the
    default) is the JAX package's automatic policy, whose last gate asks
    whether its TPU kernels could run on the padded grid: this package's
    kernels take any H×W, so padding buys no kernel and the gate answers
    False, as the JAX package answers it off a TPU. ``None`` therefore
    never pads."""
    del h, w, transform, multiple  # the policy's other gates: see above
    if config.pad_to_tile is not None:
        return bool(config.pad_to_tile)
    return False


def padded_shape(config, h: int, w: int, transform=None,
                 multiple: int = 128) -> tuple[int, int]:
    """The (h, w) the cube drivers solve: the ``multiple``-aligned sides
    when :func:`auto_pad_to_tile` engages, else (h, w)."""
    if auto_pad_to_tile(config, h, w, transform, multiple):
        return next_multiple(h, multiple), next_multiple(w, multiple)
    return int(h), int(w)


def pad_slices_to_tile(data, mask, multiple: int = 128):
    """Zero-pad a (..., H, W) slice stack and its shared (H, W) mask to the
    next ``multiple``-aligned sides, on the host.

    The frame is an observed zero: amplitude 0 with mask 1, so the POCS
    reinsertion pins it toward zero every iteration instead of filling it
    as missing traces. The transform sees the padded grid, so the solve is
    a (slightly) different, equally valid, POCS problem; callers crop back
    to ``(h, w)``, the returned original sides. The inputs come back
    unchanged when both sides are aligned. This makes a padded host copy
    of ``data``."""
    data = np.asarray(data)
    h, w = data.shape[-2:]
    hp, wp = next_multiple(h, multiple), next_multiple(w, multiple)
    if (hp, wp) == (h, w):
        return data, np.asarray(mask, np.float32), (h, w)
    padded = np.zeros(data.shape[:-2] + (hp, wp), data.dtype)
    padded[..., :h, :w] = data
    mask_p = np.ones((hp, wp), np.float32)
    mask_p[:h, :w] = np.asarray(mask, np.float32)
    return padded, mask_p, (h, w)
