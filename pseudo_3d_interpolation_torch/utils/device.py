"""Where the port computes, and how a cube-sized tensor is cut into chunks.

Every entry point that computes takes ``device=None``: the first CUDA card,
and an error without one. The host runs the plain PyTorch versions only
when the caller asks for them with ``device='cpu'``.
"""

from __future__ import annotations

import numpy as np
import torch

# device bytes one chunk of a cube-sized step may take (its input rows, or
# the widest intermediate a step states per row): large enough that a
# 512x512x1024 cube runs in a few dozen chunks, small against the card
CHUNK_BYTES = 256 << 20


def resolve_device(device=None) -> torch.device:
    """``device`` as given; by default the first CUDA device. Without a
    card that raises: the host runs the plain PyTorch versions only when
    the caller asks for them with ``device='cpu'``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is false. Pass "
            "device='cpu' to run the plain PyTorch versions on the host")
    return torch.device("cuda")


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor. A tensor stays on its device when
    ``device`` is None; anything else (numpy, lists, scalars) goes to
    :func:`resolve_device` of ``device``."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(resolve_device(device))
        return x.to(dtype) if dtype is not None else x
    x = np.asarray(x)
    if not x.flags.writeable or min(x.strides, default=0) < 0:
        x = np.array(x)  # torch.from_numpy takes neither
    t = torch.from_numpy(x)
    return t.to(device=resolve_device(device),
                dtype=dtype if dtype is not None else t.dtype)


def chunk_rows(n_rows: int, row_bytes: int, budget: int = CHUNK_BYTES):
    """``(start, stop)`` spans over ``n_rows`` rows of ``row_bytes`` each,
    as many rows a span as fit ``budget`` (at least one)."""
    step = max(1, int(budget) // max(1, int(row_bytes)))
    for start in range(0, n_rows, step):
        yield start, min(start + step, n_rows)


def map_rows(fn, x: torch.Tensor, row_bytes: int,
             budget: int = CHUNK_BYTES) -> torch.Tensor:
    """``fn`` applied to row chunks of ``x`` seen as (rows, x.shape[-1]),
    the results stacked back to ``x.shape[:-1] + (n_out,)``. ``fn`` maps
    (r, T) to (r, n_out) and acts on each row alone; ``row_bytes`` is the
    device memory one row takes inside ``fn``."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    out = None
    for a, b in chunk_rows(flat.shape[0], row_bytes, budget):
        y = fn(flat[a:b])
        if out is None:
            out = torch.empty((flat.shape[0],) + tuple(y.shape[1:]),
                              dtype=y.dtype, device=y.device)
        out[a:b] = y
    if out is None:  # no rows
        out = fn(flat)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))
