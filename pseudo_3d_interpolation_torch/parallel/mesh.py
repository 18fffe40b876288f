"""Meshes of slice-parallel processes over ``torch.distributed``: the 1-D
slice mesh and the 2-D slice × space mesh.

Counterpart of ``pseudo_3d_interpolation_tpu/parallel/mesh.py``. The JAX
package lays one global array over a ``jax.sharding.Mesh`` and lets XLA
place the blocks and insert the collectives. The port runs one process per
card, the model ``torchrun`` starts: NCCL between cards, gloo between CPU
processes. Its contract, which every sharded entry point states again:
every rank is given the same full host input, solves its own block of the
leading (slice) axis, and returns the full result, gathered. Frequency
slices are independent problems, so the solve itself needs no
communication; the collectives are the gathers of the results, the
broadcast of the mask and the all_to_all between a trace-parallel and a
slice-parallel layout (:func:`reshard_axis`).

Starting it: ``torchrun --nproc-per-node=4 script.py`` on one host sets
the rendezvous variables, and :func:`initialize_distributed` with no
arguments reads them; without ``torchrun``, pass ``coordinator``
('host:port'), ``num_processes`` and ``process_id``. With no process group
:func:`make_mesh` gives a mesh of one process, on which every collective
is a no-op.

:func:`make_mesh_2d` lays the ranks out as an n_slices × n_space grid (the
JAX package's ``make_mesh_2d``, a device array reshaped row-major): the
slice axis shards the batch of slices, the space axis the ilines of every
slice. Each rank belongs to one 1-D mesh along each axis, so the
collectives of one axis run over that axis' group only; the barriers and
broadcasts of the drivers above the solve run over the whole grid
(:func:`whole`). What a split space axis (n_space > 1) does depends on
the basis: the FFT basis splits every slice's ilines over it and solves
a distributed line FFT (``parallel.solver.SpaceShardedFFT``); DCT,
WAVELET, SHEARLET and CURVELET, and stage 2
(``pipeline.stage2.interpolate_time_cube_sharded``) for every basis,
spread whole slices over the grid, on the single-device routes and their
kernels. The drivers pad a batch to the slice axis (``slice_shards``);
the solver pads it on to the grid where it needs to.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from ..utils import timing

SLICE_AXIS = "slices"
SPACE_AXIS = "space"


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join the process group: ``init_process_group`` over
    ``tcp://<coordinator>`` with ``num_processes`` ranks, this one
    ``process_id``; with no ``coordinator``, the ``env://`` variables
    ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    ``backend``: NCCL where CUDA is available, else gloo. Call it once per
    process before :func:`make_mesh`; a run of one process skips it."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    with timing.build_span("mesh.init"):
        if coordinator is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process ``group`` (None: the default group, or no
    group at all on a mesh of one process), the global ``ranks`` it holds
    in mesh order, this process's ``index`` among them (None when it is
    not a member), the ``device`` this rank solves on and the axis
    name."""

    group: object
    ranks: tuple
    index: int | None
    device: torch.device
    axis_name: str = SLICE_AXIS

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def slice_shards(self) -> int:
        """The blocks a batch of slices is split into: the mesh's size."""
        return self.size


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A slice × space mesh: ``slices``, the 1-D mesh of the ranks that
    hold this rank's iline block (one per slice block, in order);
    ``space``, the 1-D mesh of the ranks that hold this rank's slice block
    (one per iline block, in order); ``grid``, the 1-D mesh of all its
    ranks in row-major order; ``shape`` (n_slices, n_space); this rank's
    ``device``. A rank outside the grid has ``index`` None on all
    three."""

    slices: Mesh
    space: Mesh
    grid: Mesh
    shape: tuple
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def slice_shards(self) -> int:
        """The blocks a batch of slices is split into: n_slices."""
        return self.shape[0]

    @property
    def index(self) -> int | None:
        """This rank's place in the grid, row-major (None outside it)."""
        i, j = self.slices.index, self.space.index
        return None if i is None else i * self.shape[1] + j


def _rank_device() -> torch.device:
    """This rank's device: with NCCL its card (LOCAL_RANK, torchrun's, or
    the rank, modulo the cards this host has), else the CPU."""
    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None,
              axis_name: str = SLICE_AXIS, device=None) -> Mesh:
    """The 1-D mesh over the process group's ranks, or its first
    ``n_devices`` (every rank must call it then: the subgroup is made
    collectively); a mesh of one process when no group is initialized.
    ``device``: this rank's device (by default its card under NCCL, the
    CPU under gloo; with no group, the first card or else the CPU)."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} devices, have 1 "
                             "process (initialize_distributed first)")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        return Mesh(None, (0,), 0, torch.device(device), axis_name)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    ranks = tuple(range(n))
    group = None if n == world else dist.new_group(list(ranks))
    rank = dist.get_rank()
    device = _rank_device() if device is None else torch.device(device)
    return Mesh(group, ranks, rank if rank < n else None, device, axis_name)


def make_mesh_2d(n_slices: int, n_space: int,
                 axis_names=(SLICE_AXIS, SPACE_AXIS), device=None) -> Mesh2D:
    """The n_slices × n_space mesh over the process group's first
    n_slices·n_space ranks, rank ``i·n_space + j`` at slice block i and
    iline block j; every rank must call it (the groups are made
    collectively). With no process group it is the 1 × 1 mesh of this
    process. ``device`` as :func:`make_mesh`'s. With n_space > 1 the FFT
    basis splits each slice's ilines over the space axis; every other
    basis, and stage 2, solve whole slices over the grid of all
    n_slices·n_space ranks."""
    n_slices, n_space = int(n_slices), int(n_space)
    if n_slices < 1 or n_space < 1:
        raise ValueError(f"mesh {n_slices}x{n_space} has no devices")
    if not dist.is_initialized():
        if n_slices * n_space != 1:
            raise ValueError(f"mesh {n_slices}x{n_space} needs more than 1 "
                             "process (initialize_distributed first)")
        one = make_mesh(1, axis_names[0], device)
        return Mesh2D(one, dataclasses.replace(one, axis_name=axis_names[1]),
                      one, (1, 1), one.device)
    world = dist.get_world_size()
    if n_slices * n_space > world:
        raise ValueError(f"mesh {n_slices}x{n_space} needs more than {world} "
                         "processes")
    rank = dist.get_rank()
    device = _rank_device() if device is None else torch.device(device)

    def groups(rank_lists):
        """A group for each list of ranks, made by every rank in the same
        order (None for the whole world, or a single rank, which needs no
        collective); this rank's (group, ranks)."""
        mine = (None, None)
        for ranks in rank_lists:
            g = (dist.new_group(list(ranks))
                 if 1 < len(ranks) < world else None)
            if rank in ranks:
                mine = (g, tuple(ranks))
        return mine

    rows = [[i * n_space + j for j in range(n_space)]
            for i in range(n_slices)]
    cols = [[i * n_space + j for i in range(n_slices)]
            for j in range(n_space)]
    space_group, space_ranks = groups(rows)
    slice_group, slice_ranks = groups(cols)
    n = n_slices * n_space
    grid_group, _ = groups([range(n)])
    inside = rank < n
    i, j = divmod(rank, n_space) if inside else (None, None)
    slices = Mesh(slice_group, slice_ranks or tuple(cols[0]), i, device,
                  axis_names[0])
    space = Mesh(space_group, space_ranks or tuple(rows[0]), j, device,
                 axis_names[1])
    grid = Mesh(grid_group, tuple(range(n)), rank if inside else None,
                device, axis_names[0])
    return Mesh2D(slices, space, grid, (n_slices, n_space), device)


def whole(mesh) -> Mesh:
    """The 1-D mesh of every rank of ``mesh``: a 1-D mesh itself, a 2-D
    mesh's grid. The drivers' barriers and broadcasts run over it."""
    return mesh.grid if isinstance(mesh, Mesh2D) else mesh


def pad_to_multiple(n: int, m: int) -> int:
    """Batch size padded so it divides evenly across ``m`` shards."""
    return -(-n // m) * m


def _member(mesh: Mesh) -> int:
    if mesh.index is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.ranks}")
    return mesh.index


def block(mesh: Mesh, n: int) -> slice:
    """This rank's block of a leading axis of length ``n``, which the mesh
    must divide."""
    if n % mesh.size:
        raise ValueError(f"axis of {n} not divisible by mesh size "
                         f"{mesh.size}; pad first")
    k = n // mesh.size
    i = _member(mesh)
    return slice(i * k, (i + 1) * k)


# the process groups that have run a collective here (id: group, held so
# that the id stays this group's): NCCL connects a group at its first
_CONNECTED: dict = {}


@contextlib.contextmanager
def _collective(name: str, mesh: Mesh, x: torch.Tensor):
    """The span ``name`` over one collective of the mesh's group, with the
    ``bytes`` of this rank's input ``x``; the group's first collective in
    this process is also the build span ``mesh.connect``."""
    group = dist.group.WORLD if mesh.group is None else mesh.group
    with timing.span(name, bytes=x.nbytes):
        if id(group) in _CONNECTED:
            yield
            return
        _CONNECTED[id(group)] = group
        with timing.build_span("mesh.connect"):
            yield


def _copy_in(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``, contiguous: the span ``stage2.h2d`` with its
    ``bytes`` and whether it is ``pinned``."""
    with timing.span("stage2.h2d", bytes=x.nbytes, pinned=x.is_pinned()):
        return x.to(device).contiguous()


def slice_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``x``'s leading axis on its device (the
    counterpart of the leading-axis ``NamedSharding``)."""
    return _copy_in(x[block(mesh, x.shape[0])], mesh.device)


def replicated_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` on this rank's device as the mesh's first rank holds it (the
    counterpart of the replicated ``NamedSharding``): one broadcast."""
    x = _copy_in(x, mesh.device)
    if mesh.size > 1:
        _member(mesh)
        with _collective("mesh.broadcast", mesh, x):
            dist.broadcast(x, src=mesh.ranks[0], group=mesh.group)
    return x


def gather(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's block ``x`` joined along ``axis`` in mesh order, on
    every rank (all_gather); the blocks have equal shapes."""
    if mesh.size == 1:
        return x
    _member(mesh)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    with _collective("mesh.all_gather", mesh, x):
        dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=axis)


def all_reduce(mesh: Mesh, x: torch.Tensor, op) -> torch.Tensor:
    """``x`` reduced by ``op`` over the mesh's ranks, in place (nothing on
    a mesh of one); ``x`` must be contiguous."""
    if mesh.size > 1:
        _member(mesh)
        with _collective("mesh.all_reduce", mesh, x):
            dist.all_reduce(x, op, group=mesh.group)
    return x


def reshard_axis(x: torch.Tensor, mesh: Mesh, axis: int,
                 src_axis: int = 0) -> torch.Tensor:
    """Re-lay a block so that ``axis`` is the sharded one: ``x`` is this
    rank's block along ``src_axis``, the result its block along ``axis``
    (the full ``src_axis``), by one ``all_to_all_single``. The device-
    resident replacement for the reference's on-disk time-major /
    slice-major transpose (cube_binning_3D.py:1313-1351), between stages
    that want different parallel axes (a trace-parallel time FFT, the
    slice-parallel POCS)."""
    p = mesh.size
    if p == 1:
        return x
    _member(mesh)
    n = x.shape[axis]
    if n % p:
        raise ValueError(f"axis {axis} of {n} not divisible by mesh size "
                         f"{p}; pad first")
    send = x.movedim(axis, 0).reshape((p, n // p) + tuple(
        s for d, s in enumerate(x.shape) if d != axis)).contiguous()
    recv = torch.empty_like(send)
    with _collective("mesh.all_to_all", mesh, send):
        dist.all_to_all_single(recv, send, group=mesh.group)
    # recv[i]: rank i's block along src_axis of this rank's block along axis
    return torch.cat(list(recv.movedim(1, axis + 1)), dim=src_axis)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh, 1-D or 2-D (none on a mesh of
    one)."""
    mesh = whole(mesh)
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
