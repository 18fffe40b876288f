"""Cube drivers: solve every slice of a (F, H, W) cube on one device, or
over a 1-D mesh of processes.

Counterpart of ``pseudo_3d_interpolation_tpu/parallel/solver.py``.
:func:`interpolate_cube_resident` uploads the cube once, solves it batch by
batch on the device and downloads the result once;
:func:`interpolate_cube` moves one batch at a time, for cubes that do not
fit the device; :func:`pocs_interpolate_scanned` solves a cube that is
already on the device and leaves the result there. They run eagerly, so a
short last batch needs no zero padding (the JAX drivers padded it to keep
one compiled program). With ``config.pad_to_tile`` the two cube drivers
solve every slice zero-padded to 128-multiple sides and crop the result
(``utils/pad``).

Sharding (``parallel/mesh.py``): :func:`pocs_interpolate_sharded` and
:func:`interpolate_cube` with a ``mesh`` split each batch's slices over the
mesh's processes. Every rank is given the same full host input, solves its
own block of the batch on its device and returns the full result,
gathered; the batch is padded with zero slices to a multiple of the mesh
(they short-circuit, so padding is free). ``mesh=None`` keeps the
single-device drivers.

On a 2-D slice × space mesh (``mesh.make_mesh_2d``) whose space axis is
split, the FFT basis also spreads the ilines of every slice over the
space axis: the solve is a distributed line FFT (:class:`SpaceShardedFFT`),
each iteration's per-slice sums ``all_reduce``d over the space group. The
JAX package gets the same from XLA partitioning its DFT matmuls; no
kernel runs there (the folded solve needs a whole slice). Every other
basis spreads whole slices over all the mesh's ranks (its ``grid``) and
solves them on the single-device routes and their kernels, with no
collective in the solve. A 2-D mesh of one space rank is the 1-D path
over its slice axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pocs import (POCSConfig, POCSResult, SolverRoute, _scan,
                           pocs_interpolate)
from ..models.transforms import FFTTransform, get_transform
from ..ops import decay as decay_ops
from ..ops import threshold as threshold_ops
from ..ops.cplx import Cplx, from_complex, to_complex
from ..utils.device import resolve_device
from ..utils.pad import auto_pad_to_tile, pad_slices_to_tile
from . import mesh as mesh_lib

__all__ = ["resolve_device", "fits_resident", "interpolate_cube_resident",
           "interpolate_cube", "pocs_interpolate_scanned",
           "pocs_interpolate_sharded", "SpaceShardedFFT"]

def fits_resident(device, n_slices: int, batch: int, h: int, w: int,
                  expansion: int = 1, extra_bytes: int = 0) -> bool:
    """Whether :func:`interpolate_cube_resident` fits in ``device``'s free
    memory. Its peak is two cube-sized float32 pairs (the input and the
    result; the complex staging copy of the upload and of the download
    replaces one of them while it lives) and one batch's solve buffers.
    A folded solve's are five pairs per slice (the batch's input, the
    kernel's work, two pairs on every basis, its output and the decay's
    spectrum); ``expansion`` scales that for other bases, and
    ``extra_bytes`` adds what does not scale with the slices (a
    directional basis's windows and kernel scratch). The rule asks for
    three cubes and eight pairs per slice of the batch times
    ``expansion``. ``h`` and ``w`` are the sides the driver solves (padded
    under ``pad_to_tile``). A CPU "device" is the host memory that already
    holds the cube: it always fits."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(
        device)
    return ((3 * n_slices + 8 * batch * expansion) * h * w * 8 + extra_bytes
            <= free)


def _to_host(rec: Cplx, was_complex: bool) -> np.ndarray:
    return to_complex(rec) if was_complex else rec.re.contiguous().cpu(
        ).numpy()


def _crop(rec: Cplx, crop) -> Cplx:
    """The (..., h, w) top-left corner of padded slices; ``crop`` None
    leaves them whole."""
    if crop is None:
        return rec
    h, w = crop
    return Cplx(rec.re[..., :h, :w], rec.im[..., :h, :w])


def _empty(data: np.ndarray, was_complex: bool):
    return (np.empty(data.shape, np.complex64 if was_complex else np.float32),
            np.empty((0,), np.int32), np.empty((0,), np.float32))


def interpolate_cube_resident(data, mask, config: POCSConfig = POCSConfig(),
                              transform=None, batch: int = 8, progress=None,
                              device=None, _max_launches: int | None = None):
    """Device-resident cube driver: one upload, per-batch solves on the
    device, one download.

    ``data``: (F, H, W) complex64 or float32 numpy array; ``mask``: (H, W)
    shared sampling mask; ``progress``: optional ``callable(done, total)``.
    Returns numpy ``(recon, n_iterations, cost)``: (F, H, W), (F,), (F,).
    ``_max_launches`` solves only the first that many batches of the full
    cube (``pipeline.pocs.warmup``: one launch at the production shapes);
    the other slices' results are then undefined.
    """
    if transform is None:
        transform = get_transform(config.transform_kind)
    device = resolve_device(device)
    data = np.asarray(data)
    was_complex = np.iscomplexobj(data)
    f_total = data.shape[0]
    if f_total == 0:
        return _empty(data, was_complex)
    crop = None
    if auto_pad_to_tile(config, data.shape[-2], data.shape[-1], transform):
        data, mask, crop = pad_slices_to_tile(data, mask)
    z = from_complex(data, device)
    m = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    rec = Cplx(torch.empty_like(z.re), torch.empty_like(z.im))
    iters = torch.empty(f_total, dtype=torch.int32, device=device)
    cost = torch.empty(f_total, dtype=torch.float32, device=device)
    batch = max(1, min(batch, f_total))
    starts = range(0, f_total, batch)
    if _max_launches is not None:
        starts = starts[:_max_launches]
    for start in starts:
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
    return (_to_host(_crop(rec, crop), was_complex), iters.cpu().numpy(),
            cost.cpu().numpy())


class SpaceShardedFFT:
    """The FFT basis on slices whose ilines are spread over the ranks of a
    1-D mesh (a 2-D mesh's space axis), as a distributed line FFT.

    Each rank holds (B, H/p, W) rows of every slice. :meth:`forward`
    transforms its rows along the xlines (``torch.fft``), re-lays them by
    one ``all_to_all_single`` so it holds (B, H, W/p) columns, and
    transforms those along the ilines: the coefficients of a column block.
    :meth:`inverse` runs the same steps backwards, so the reinsertion acts
    on the local rows. The decay (once a solve) and the ``*-percentile``
    thresholds (once an iteration) read the whole slice's magnitudes,
    their column blocks gathered over the space group; :meth:`slice_sum`
    (the cost and the zero-slice test) is an ``all_reduce`` over it: every
    rank of a slice block takes the same thresholds and the same
    decisions. The layouts match
    ``models.transforms.FFTTransform`` (``torch.fft`` unscaled forward,
    1/(H·W) inverse), so the solve is the single-device one up to the
    order of its float32 sums."""

    def __init__(self, space: mesh_lib.Mesh):
        self.space = space

    def _relay(self, x: torch.Tensor, axis: int, src_axis: int
               ) -> torch.Tensor:
        # gloo's all_to_all takes no complex tensors: move (re, im) pairs
        y = mesh_lib.reshard_axis(torch.view_as_real(x), self.space, axis,
                                  src_axis)
        return torch.view_as_complex(y.contiguous())

    def forward(self, z: Cplx) -> Cplx:
        x = torch.fft.fft(torch.complex(z.re, z.im), dim=-1)
        x = torch.fft.fft(self._relay(x, x.dim() - 1, x.dim() - 2), dim=-2)
        return Cplx(x.real.contiguous(), x.imag.contiguous())

    def inverse(self, coeffs: Cplx) -> Cplx:
        x = torch.fft.ifft(torch.complex(coeffs.re, coeffs.im), dim=-2)
        x = torch.fft.ifft(self._relay(x, x.dim() - 2, x.dim() - 1), dim=-1)
        return Cplx(x.real.contiguous(), x.imag.contiguous())

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.space.size > 1:
            import torch.distributed as dist

            t = t.contiguous()
            dist.all_reduce(t, op=op, group=self.space.group)
        return t

    def slice_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over each whole slice of a (B, rows, cols) block."""
        import torch.distributed as dist

        return self._all_reduce(torch.sum(t, dim=(-2, -1)), dist.ReduceOp.SUM)

    def decay(self, coeffs: Cplx, model, niter, p_max, p_min, decay_kind):
        return decay_ops.threshold_decay(
            mesh_lib.gather(self.space, coeffs.abs(), axis=-1), model, niter,
            p_max=p_max, p_min=p_min, kind=decay_kind)

    def threshold(self, coeffs: Cplx, t, op: str) -> Cplx:
        t = t[..., None, None]
        base = op.removesuffix("-percentile")
        if base != op:  # the percentile of the whole slice's magnitudes
            t = threshold_ops._percentile_from_mag(
                mesh_lib.gather(self.space, coeffs.abs(), axis=-1), t)
        return threshold_ops.threshold_pair(coeffs, t, kind=base)


def _space_sharded_fft(z: Cplx, mask, mesh: mesh_lib.Mesh2D,
                       config: POCSConfig) -> POCSResult:
    """The FFT basis on a split slice × space mesh: this rank's slice
    block and iline block, the distributed FFT solve through the scan,
    the result gathered over both axes."""
    b, h, w = z.shape
    n_space = mesh.shape[1]
    if h % n_space or w % n_space:
        raise ValueError(f"slices of {h}x{w} do not split over {n_space} "
                         "space ranks (both sides must divide)")
    rows = mesh_lib.block(mesh.space, h)
    sl = mesh_lib.block(mesh.slices, b)
    local = Cplx(z.re[sl, rows].to(mesh.device).contiguous(),
                 z.im[sl, rows].to(mesh.device).contiguous())
    m = torch.as_tensor(mask, dtype=torch.float32)[rows].to(
        mesh.device).contiguous()
    res = _scan(local, m, SpaceShardedFFT(mesh.space), config,
                SolverRoute("xla-scan", "fft", "slices spread over a 2-D "
                            "mesh's space axis"))

    def whole(t):  # the iline blocks, then the slice blocks
        return mesh_lib.gather(mesh.slices, mesh_lib.gather(mesh.space, t,
                                                            axis=1))
    history = res.cost_history
    if history is not None:
        history = mesh_lib.gather(mesh.slices, history, axis=1)
    return POCSResult(Cplx(whole(res.data.re), whole(res.data.im)),
                      mesh_lib.gather(mesh.slices, res.n_iterations),
                      mesh_lib.gather(mesh.slices, res.cost), history)


def _slice_sharded(z: Cplx, mask, mesh: mesh_lib.Mesh, transform,
                   config: POCSConfig) -> POCSResult:
    """The 1-D path: this rank's block of the batch solved on its device,
    the results gathered."""
    local = Cplx(mesh_lib.slice_sharding(mesh, z.re),
                 mesh_lib.slice_sharding(mesh, z.im))
    m = mesh_lib.replicated_sharding(
        mesh, torch.as_tensor(mask, dtype=torch.float32))
    res = pocs_interpolate(local, m, transform, config)
    history = res.cost_history
    if history is not None:
        history = mesh_lib.gather(mesh, history, axis=1)
    return POCSResult(Cplx(mesh_lib.gather(mesh, res.data.re),
                           mesh_lib.gather(mesh, res.data.im)),
                      mesh_lib.gather(mesh, res.n_iterations),
                      mesh_lib.gather(mesh, res.cost), history)


def _whole_slices(z: Cplx, mask, mesh: mesh_lib.Mesh, transform,
                  config: POCSConfig) -> POCSResult:
    """Every other basis on a split slice × space mesh: whole slices over
    the 1-D mesh of all its ranks (``mesh.grid``), the batch padded on
    inside with zero slices to a multiple of it and cropped again."""
    b = z.shape[0]
    pad = mesh_lib.pad_to_multiple(b, mesh.size) - b
    if pad:
        z = Cplx(*(torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
                   for t in (z.re, z.im)))
    res = _slice_sharded(z, mask, mesh, transform, config)
    if not pad:
        return res
    history = res.cost_history
    return POCSResult(Cplx(res.data.re[:b], res.data.im[:b]),
                      res.n_iterations[:b], res.cost[:b],
                      None if history is None else history[:, :b])


def pocs_interpolate_sharded(z: Cplx, mask, mesh=None, transform=None,
                             config: POCSConfig = POCSConfig()
                             ) -> POCSResult:
    """Solve a batch of slices split over the mesh's slice axis.

    ``z``: (B, H, W) ``Cplx``, the same full batch on every rank, with B a
    multiple of the mesh size (pad with zero slices: they short-circuit to
    zero output, reference POCS.py:515-521, so padding is free); ``mask``
    (H, W), which the mesh's first rank broadcasts. Each rank solves its
    block on its device (``mesh.device``) and returns the full result
    gathered there, the history (when kept) gathered along its batch axis.
    ``mesh`` defaults to :func:`mesh.make_mesh`. ``config.pad_to_tile`` is
    not read at this layer (the cube drivers pad before calling in).

    On a 2-D mesh (:func:`mesh.make_mesh_2d`) whose space axis is split,
    the basis picks the path. The FFT basis puts the slices over the
    slice axis and the ilines over the space axis (both sides of a slice
    must divide by it) and is solved as a distributed line FFT
    (:class:`SpaceShardedFFT`) through the plain scan: regular, fast and
    adaptive, with early stopping and cost history. DCT, WAVELET,
    SHEARLET and CURVELET spread whole slices over all the mesh's ranks
    (``mesh.grid``, row-major) and take the routes ``solver_route`` picks
    on one device: the folded DCT and WAVELET solves, ``streamed-subband``
    for SHEARLET and CURVELET (the split percentile passes under a
    ``*-percentile`` threshold), ``xla-scan`` where the route says so. A
    batch that divides by the slice axis but not by the grid is padded on
    inside with zero slices, which are cropped off again. The JAX package
    repeats each slice block over the space axis instead; each slice is
    solved whole either way. A 2-D mesh with one space rank splits
    nothing but slices: it takes the 1-D path over its slice axis, every
    basis and the folded kernels included."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    if transform is None:
        transform = get_transform(config.transform_kind)
    b = z.shape[0]
    if b % mesh.slice_shards:
        raise ValueError(f"batch {b} not divisible by mesh size "
                         f"{mesh.slice_shards} (its slice axis); pad first")
    if isinstance(mesh, mesh_lib.Mesh2D):
        if mesh.shape[1] == 1:  # no space split: the 1-D path, every basis
            return _slice_sharded(z, mask, mesh.slices, transform, config)
        if isinstance(transform, FFTTransform):
            return _space_sharded_fft(z, mask, mesh, config)
        return _whole_slices(z, mask, mesh.grid, transform, config)
    return _slice_sharded(z, mask, mesh, transform, config)


def interpolate_cube(data, mask, config: POCSConfig = POCSConfig(),
                     transform=None, batch: int = 128, progress=None,
                     device=None, mesh=None):
    """Host-chunked cube driver: each batch of slices goes to the device,
    is solved and comes back before the next. Same arguments and returns
    as :func:`interpolate_cube_resident`. Under ``pad_to_tile`` each batch
    is padded on its way to the device and cropped on its way back, so the
    host holds no padded copy of the cube.

    With a ``mesh`` (``parallel/mesh.py``) the batch is rounded up to a
    multiple of the mesh and each batch, the short tail padded with zero
    slices to a multiple of the mesh, goes through
    :func:`pocs_interpolate_sharded`: every rank passes the same cube,
    solves its block of each batch on ``mesh.device`` (``device`` is not
    read) and returns the whole result."""
    if transform is None:
        transform = get_transform(config.transform_kind)
    if mesh is None:
        device = resolve_device(device)
    data = np.asarray(data)
    was_complex = np.iscomplexobj(data)
    f_total = data.shape[0]
    if f_total == 0:
        return _empty(data, was_complex)
    out = np.empty(data.shape, np.complex64 if was_complex else np.float32)
    n_iters = np.empty((f_total,), np.int32)
    costs = np.empty((f_total,), np.float32)
    crop, m = None, mask
    if auto_pad_to_tile(config, data.shape[-2], data.shape[-1], transform):
        _, m, crop = pad_slices_to_tile(data[:0], mask)  # the padded mask
    if mesh is not None:
        m = np.asarray(m, np.float32)
        batch = mesh_lib.pad_to_multiple(max(1, min(batch, f_total)),
                                         mesh.slice_shards)
    else:
        m = torch.as_tensor(np.asarray(m, np.float32), device=device)
        batch = max(1, min(batch, f_total))
    for start in range(0, f_total, batch):
        stop = min(start + batch, f_total)
        chunk = data[start:stop]
        if crop is not None:
            chunk = pad_slices_to_tile(chunk, mask)[0]
        if mesh is not None:
            # the short tail, padded to a multiple of the mesh
            pad = mesh_lib.pad_to_multiple(stop - start, mesh.slice_shards)
            if pad > stop - start:
                chunk = np.concatenate([chunk, np.zeros(
                    (pad - chunk.shape[0],) + chunk.shape[1:], chunk.dtype)])
            res = pocs_interpolate_sharded(from_complex(chunk), m, mesh,
                                           transform, config)
            res = POCSResult(Cplx(res.data.re[:stop - start],
                                  res.data.im[:stop - start]),
                             res.n_iterations[:stop - start],
                             res.cost[:stop - start], None)
        else:
            res = pocs_interpolate(from_complex(chunk, device), m,
                                   transform, config)
        out[start:stop] = _to_host(_crop(res.data, crop), was_complex)
        n_iters[start:stop] = res.n_iterations.cpu().numpy()
        costs[start:stop] = res.cost.cpu().numpy()
        if progress is not None:
            progress(stop, f_total)
    return out, n_iters, costs


def pocs_interpolate_scanned(z: Cplx, mask, transform=None,
                             config: POCSConfig = POCSConfig(),
                             batch: int = 8):
    """Solve a whole (F, H, W) cube held on the device, batch by batch,
    and leave the result there: the JAX package's ``lax.scan`` over
    batches is a loop over them here, each batch's slices and results
    staying on the device (no host copy between batches).

    ``z``: a ``Cplx`` of (F, H, W) tensors with F a multiple of ``batch``
    (pad with zero slices: they short-circuit to zero output); ``mask``:
    (H, W), on any device. Returns ``(Cplx, n_iterations, cost)`` as
    F-length tensors on ``z``'s device. ``config.pad_to_tile`` is not
    read here: it is the cube drivers' option, and the caller's slices
    are solved at the shape they come in."""
    if transform is None:
        transform = get_transform(config.transform_kind)
    f_total = z.shape[0]
    if f_total % batch:
        raise ValueError(f"slices {f_total} not divisible by batch {batch}; "
                         "pad first")
    device = z.re.device
    m = torch.as_tensor(mask, dtype=torch.float32).to(device)
    rec = Cplx(torch.empty_like(z.re), torch.empty_like(z.im))
    iters = torch.empty(f_total, dtype=torch.int32, device=device)
    cost = torch.empty(f_total, dtype=torch.float32, device=device)
    for start in range(0, f_total, batch):
        stop = start + batch
        res = pocs_interpolate(Cplx(z.re[start:stop], z.im[start:stop]), m,
                               transform, config)
        rec.re[start:stop] = res.data.re
        rec.im[start:stop] = res.data.im
        iters[start:stop] = res.n_iterations
        cost[start:stop] = res.cost
    return rec, iters, cost

