"""Trace-to-bin assignment on the host, and stacking as tensor reductions.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/binning.py``. reference:
the per-iline Python stacking loops of
pseudo_3D_interpolation/cube_binning_3D.py:922-1240 (average/median/nearest/
IDW with per-trace delay padding, zero infill, fold channel). Trace->bin
assignment happens once on the host (affine matmul + rounding), as in the
JAX package; each stack is one reduction over a whole block of traces, on
the device of the traces (numpy goes to ``device``, by default the first
CUDA card; a tensor stays where it is):

  - ``average``: ``index_add_`` of the traces / fold
  - ``idw``:     normalized inverse-distance weighted ``index_add_``
                 (weights 1/d^power, reference :986-1002)
  - ``nearest``: ``scatter_reduce(amin)`` of the distance to the bin
                 center, then of the trace order among the traces at that
                 minimum (the first one wins), then a gather
  - ``median``:  rank-within-bin scatter into a dense (bins, max_fold)
                 slot array of the bins that hold a trace, a sort of the
                 slots, and the mean of the two middle ranks of the valid
                 ones (``jnp.nanmedian``'s midpoint rule), in chunks of
                 bins that fit the device

Empty bins yield zero traces (the reference's explicit zero infill,
:1152-1166); the ``fold`` channel is the trace count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import CHUNK_BYTES, as_tensor, chunk_rows, resolve_device

STACK_METHODS = ("average", "mean", "median", "nearest", "idw")


def assign_bins(x, y, transform, n_ilines: int, n_xlines: int):
    """Host: CRS coords -> (iline, xline, valid) integer bin assignment.

    ``transform`` maps coordinates to fractional line numbers starting at 1
    (ops/affine.py). Traces outside the grid get ``valid=False``.
    """
    pts = np.column_stack([np.asarray(x, float), np.asarray(y, float)])
    ilxl = transform.transform(pts)
    il = np.rint(ilxl[:, 0]).astype(np.int32)
    xl = np.rint(ilxl[:, 1]).astype(np.int32)
    valid = (il >= 1) & (il <= n_ilines) & (xl >= 1) & (xl <= n_xlines)
    return il, xl, valid


def assign_bins_indexed(x, y, transform, il_indices, xl_indices):
    """Host: CRS coords -> positions in explicit (possibly stepped) index
    lists — the nested-region grid case (reference cube_binning_3D.py:
    491-529). Traces snap to the nearest listed line; ``valid`` requires
    landing within half the local step of it.

    Returns (pos_il, pos_xl, valid) with 0-based positions.
    """
    pts = np.column_stack([np.asarray(x, float), np.asarray(y, float)])
    frac = transform.transform(pts)

    def snap(vals, indices):
        indices = np.asarray(indices, float)
        if len(indices) > 1 and not (np.diff(indices) > 0).all():
            raise ValueError(
                "index list must be strictly ascending (searchsorted "
                "returns garbage positions otherwise)")
        pos = np.clip(np.searchsorted(indices, vals), 0, len(indices) - 1)
        pos_lo = np.clip(pos - 1, 0, len(indices) - 1)
        choose_lo = np.abs(vals - indices[pos_lo]) <= np.abs(vals - indices[pos])
        pos = np.where(choose_lo, pos_lo, pos)
        # validity tolerance from the LOCAL step at the snapped position:
        # nested-region lists change step along the list (e.g. steps 2
        # then 4)
        if len(indices) > 1:
            gaps = np.diff(indices)
            local = np.maximum(gaps[np.clip(pos - 1, 0, len(gaps) - 1)],
                               gaps[np.clip(pos, 0, len(gaps) - 1)])
        else:
            local = np.asarray(1.0)
        ok = np.abs(vals - indices[pos]) <= local / 2.0 + 1e-9
        return pos.astype(np.int32), ok

    pi, ok_i = snap(frac[:, 0], il_indices)
    px, ok_x = snap(frac[:, 1], xl_indices)
    return pi, px, ok_i & ok_x


def bin_index(il, xl, n_xlines: int):
    """(il, xl) (1-based) -> flat bin id (0-based, il-major)."""
    return (np.asarray(il) - 1) * n_xlines + (np.asarray(xl) - 1)


def _inputs(traces, bin_ids, device):
    """Traces as float32 on ``device`` (a tensor stays where it is when
    ``device`` is None) and the bin ids as int64 beside them."""
    tr = as_tensor(traces, device)
    return tr, as_tensor(bin_ids, tr.device, torch.int64)


def fold_map(bin_ids, n_bins: int, device=None) -> torch.Tensor:
    """Traces-per-bin count (the ``fold`` data variable), int32."""
    ids = as_tensor(bin_ids, device, torch.int64)
    return torch.bincount(ids, minlength=n_bins)[:n_bins].to(torch.int32)


def stack_average(traces, bin_ids, n_bins: int, device=None) -> torch.Tensor:
    """Mean stack: (ntraces, nsamples) -> (n_bins, nsamples)."""
    tr, ids = _inputs(traces, bin_ids, device)
    s = tr.new_zeros((n_bins, tr.shape[-1])).index_add_(0, ids, tr)
    fold = tr.new_zeros((n_bins,)).index_add_(0, ids, tr.new_ones(ids.shape))
    return s / torch.where(fold == 0, 1.0, fold)[:, None]


def stack_idw(traces, bin_ids, dist, n_bins: int, power: float = 1.0,
              eps: float = 1e-10, device=None) -> torch.Tensor:
    """Inverse-distance-weighted stack; ``dist`` = trace-to-bin-center
    distance. The weights are computed in the traces' dtype."""
    tr, ids = _inputs(traces, bin_ids, device)
    w = 1.0 / (as_tensor(dist, tr.device, tr.dtype) ** power + eps)
    num = tr.new_zeros((n_bins, tr.shape[-1])).index_add_(
        0, ids, tr * w[:, None])
    den = tr.new_zeros((n_bins,)).index_add_(0, ids, w)
    return num / torch.where(den == 0, 1.0, den)[:, None]


def stack_nearest(traces, bin_ids, dist, n_bins: int,
                  device=None) -> torch.Tensor:
    """Keep the trace closest to each bin center; among traces at the same
    distance, the first."""
    tr, ids = _inputs(traces, bin_ids, device)
    d = as_tensor(dist, tr.device, torch.float32)
    n = ids.shape[0]
    dmin = torch.full((n_bins,), float("inf"), device=tr.device).scatter_reduce(
        0, ids, d, "amin", include_self=False)
    order = torch.arange(n, device=tr.device)
    cand = torch.where(d <= dmin[ids], order, n)
    winner = torch.full((n_bins,), n, device=tr.device).scatter_reduce(
        0, ids, cand, "amin", include_self=False)
    hit = winner < n
    out = tr[torch.where(hit, winner, 0)]
    return torch.where(hit[:, None], out, 0.0)


def _median_budget(device: torch.device) -> int:
    """Device bytes one chunk of the median may take: a quarter of the
    card's free memory, CHUNK_BYTES on the host."""
    if device.type == "cuda":
        return max(CHUNK_BYTES, torch.cuda.mem_get_info(device)[0] // 4)
    return CHUNK_BYTES


def stack_median(traces, bin_ids, n_bins: int, max_fold: int, device=None,
                 budget: int | None = None) -> torch.Tensor:
    """Median stack, the mean of the two middle values where a bin holds
    an even number (``jnp.nanmedian``: NaN samples are left out, a bin
    with no valid sample gives 0).

    ``max_fold`` must be >= the true maximum fold. Each trace lands in slot
    ``rank`` of its bin's row of a dense (bins, max_fold, nsamples) array
    of the bins that hold a trace; empty slots hold NaN and sort last. The
    bins run in chunks of at most ``budget`` device bytes (by default a
    quarter of the card's free memory); ``traces`` may stay on the host,
    and then each chunk uploads only its own traces.
    """
    ids = (bin_ids.cpu().numpy() if isinstance(bin_ids, torch.Tensor)
           else np.asarray(bin_ids)).astype(np.int64)
    dev = (traces.device if isinstance(traces, torch.Tensor) and device is None
           else resolve_device(device))
    ns = traces.shape[-1]
    out = torch.zeros((n_bins, ns), dtype=torch.float32, device=dev)
    if ids.size == 0:
        return out
    # rank of each trace within its bin: position inside equal-id runs of a
    # stable sort (host: tiny integer pass)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    run_start = np.r_[0, np.nonzero(np.diff(sorted_ids))[0] + 1]
    run_end = np.r_[run_start[1:], len(ids)]
    fold = run_end - run_start
    if fold.max() > max_fold:
        raise ValueError(f"max_fold {max_fold} is below the largest fold "
                         f"{int(fold.max())}")
    rank = np.arange(len(ids)) - np.repeat(run_start, fold)
    slot = np.repeat(np.arange(len(run_start)), fold)  # dense row per trace
    occupied = sorted_ids[run_start]
    # per bin-sample: max_fold slots (float32 in, float32 + int64 out of
    # the sort), the count of valid slots and two gathered ranks
    bin_bytes = ns * (max_fold * 17 + 32)
    for a, b in chunk_rows(len(occupied), bin_bytes,
                           budget or _median_budget(dev)):
        r0, r1 = run_start[a], run_end[b - 1]
        rows = order[r0:r1]
        if isinstance(traces, torch.Tensor):
            blk = traces.index_select(
                0, torch.from_numpy(rows).to(traces.device)).to(dev)
        else:
            blk = torch.from_numpy(np.asarray(traces)[rows]).to(dev)
        dense = torch.full((b - a, max_fold, ns), float("nan"), device=dev)
        dense[torch.from_numpy(slot[r0:r1] - a).to(dev),
              torch.from_numpy(rank[r0:r1]).to(dev)] = blk.float()
        del blk
        valid = (~torch.isnan(dense)).sum(1, keepdim=True)
        dense = torch.sort(dense, dim=1).values
        lo = dense.gather(1, ((valid - 1).clamp(min=0) // 2))
        hi = dense.gather(1, (valid // 2).clamp(max=max_fold - 1))
        del dense
        out[torch.from_numpy(occupied[a:b]).to(dev)] = torch.nan_to_num(
            (lo + hi)[:, 0] * 0.5)
    return out


def stack_traces(traces, bin_ids, n_bins: int, method: str = "average",
                 dist=None, idw_power: float = 1.0,
                 max_fold: int | None = None, device=None) -> torch.Tensor:
    """Dispatch by stacking method (reference cube geometry config key
    ``bin_stacking_method``)."""
    if method in ("average", "mean"):
        return stack_average(traces, bin_ids, n_bins, device)
    if method == "idw":
        if dist is None:
            raise ValueError("idw stacking requires trace-to-bin-center distances")
        return stack_idw(traces, bin_ids, dist, n_bins, power=idw_power,
                         device=device)
    if method == "nearest":
        if dist is None:
            raise ValueError("nearest stacking requires trace-to-bin-center distances")
        return stack_nearest(traces, bin_ids, dist, n_bins, device)
    if method == "median":
        if max_fold is None:
            ids = (bin_ids.cpu().numpy() if isinstance(bin_ids, torch.Tensor)
                   else np.asarray(bin_ids))
            max_fold = int(np.bincount(ids, minlength=n_bins).max())
        return stack_median(traces, bin_ids, n_bins, max(max_fold, 1),
                            device)
    raise ValueError(f"unknown stacking method {method!r}; choose one of {STACK_METHODS}")


def pad_traces_to_global_twt(traces, delrt, twt0: float, dt: float, n_samples_out: int):
    """Place variable-delay traces onto the shared global TWT axis.

    Host equivalent of the reference's per-trace ``pad_trace``
    (cube_binning_3D.py:299-342): each trace starts at its
    ``DelayRecordingTime``; output sample t holds
    ``trace[t - offset]`` (0 outside the recorded window).

    numpy on the host by design, as in the JAX package: binning streams
    traces on the host and uploads each padded block once; delrt values
    are few, so traces group into a handful of contiguous copies.
    """
    traces = np.asarray(traces)
    ntr, ns = traces.shape
    off = np.rint((np.asarray(delrt, np.float64) - twt0) / dt).astype(np.int64)
    out = np.zeros((ntr, n_samples_out), traces.dtype)
    for o in np.unique(off):
        rows = off == o
        d0 = max(int(o), 0)
        d1 = min(int(o) + ns, n_samples_out)
        if d1 <= d0:
            continue
        s0 = d0 - int(o)
        out[rows, d0:d1] = traces[rows, s0 : s0 + (d1 - d0)]
    return out


def bin_center_distances(x, y, il, xl, ilxl_to_coords):
    """Host: distance from each trace to its assigned bin center."""
    centers = ilxl_to_coords.transform(np.column_stack([il, xl]).astype(float))
    return np.hypot(np.asarray(x) - centers[:, 0], np.asarray(y) - centers[:, 1])
