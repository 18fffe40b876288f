"""Host <-> card copies of whole cubes through a reused pinned staging ring.

A pageable ``.to(device)`` or ``.cpu()`` makes CUDA stage the data
through its own small pinned buffer on one host thread, and a fresh
pageable destination takes its page faults on that thread too. Here a
copy of a pageable host tensor to or from a CUDA card goes through two
pinned buffers of :data:`CHUNK_BYTES`, built once per process and card
(the build span ``stage2.staging``) and reused by every later copy. The
host's side of each chunk is split over the ring's own threads, and it
overlaps the card's DMA of the other buffer's chunk:

- :func:`to_device`: chunk k is copied into buffer k mod 2 (once that
  buffer's last DMA is done) and its DMA enqueued on the current stream;
- :func:`to_host`: the DMA of chunk k + 1 is enqueued into the free buffer
  before the host copies chunk k out of the other one into a plain
  pageable tensor, which goes back to the caller; the first-touch page
  faults of that tensor are spread over the threads.

The ring takes this process's share of the host's cores, one process
running each card (:func:`_workers`), and not torch's intra-op threads:
those number every core of the host in every process, so the ranks of a
mesh on one host, copying at once, would oversubscribe it.

Each buffer's event, recorded after its DMA, is the only wait: no device
synchronisation. Where the copy is not between a pageable host tensor and
a CUDA card, or moves less than one chunk, it is the plain ``.to()`` /
``.cpu()``. Either way the result holds the same bytes.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils import timing

CHUNK_BYTES = 64 << 20  # a staging buffer; the ring holds two
PAGE = 4096  # the host copy's parts start on page boundaries


def _workers() -> int:
    """This process's share of the host's cores: the cores it may run on
    over the cards the host holds (the port runs one process a card)."""
    cores = len(os.sched_getaffinity(0))
    return max(1, cores // max(1, torch.cuda.device_count()))


class _Ring:
    """Two staging buffers of ``chunk`` bytes on the host, pinned for a
    CUDA ``device``; each buffer's event, recorded on the device's current
    stream after the buffer's last DMA (none off the card, where every
    copy is done when it returns); and ``workers`` host threads."""

    def __init__(self, device: torch.device, chunk: int, workers: int):
        cuda = device.type == "cuda"
        self.device = device
        self.buffers = [torch.empty(chunk, dtype=torch.uint8, pin_memory=cuda)
                        for _ in range(2)]
        self.events = [torch.cuda.Event(blocking=True) if cuda else None
                       for _ in range(2)]
        self.workers = workers
        self.pool = ThreadPoolExecutor(workers,
                                       thread_name_prefix="p3d-staging")
        self.lock = threading.Lock()

    def wait(self, i: int) -> None:
        """Block the host until buffer ``i``'s last DMA is done."""
        if self.events[i] is not None:
            self.events[i].synchronize()

    def mark(self, i: int) -> None:
        """Record buffer ``i``'s event after the DMA just enqueued."""
        if self.events[i] is not None:
            self.events[i].record(torch.cuda.current_stream(self.device))

    def host_copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst[:] = src`` (flat uint8 host tensors of one length) in
        parts over the ring's threads."""
        d, s = dst.numpy(), src.numpy()
        step = -(-d.size // self.workers // PAGE) * PAGE or PAGE
        parts = [self.pool.submit(np.copyto, d[a:a + step], s[a:a + step])
                 for a in range(0, d.size, step)]
        for p in parts:
            p.result()


_RINGS: dict = {}


def _ring(device: torch.device) -> _Ring:
    """This process's ring for ``device``, built at its first use."""
    ring = _RINGS.get(device)
    if ring is None:
        with timing.build_span("stage2.staging"):
            ring = _RINGS[device] = _Ring(device, CHUNK_BYTES, _workers())
    return ring


def _chunks(device_type: str, host_type: str, pinned: bool,
            nbytes: int) -> int:
    """The chunks of a copy between a CUDA card and a pageable host tensor
    of at least one chunk; 0 for any other copy (the plain path)."""
    if (device_type != "cuda" or host_type != "cpu" or pinned
            or nbytes < CHUNK_BYTES):
        return 0
    return -(-nbytes // CHUNK_BYTES)


def upload_chunks(t: torch.Tensor, device) -> int:
    """The chunks in which :func:`to_device` moves ``t``; 0: plain."""
    return _chunks(torch.device(device).type, t.device.type, t.is_pinned(),
                   t.nbytes)


def download_chunks(t: torch.Tensor) -> int:
    """The chunks in which :func:`to_host` moves ``t``; 0: plain. Its
    destination is always a fresh pageable tensor."""
    return _chunks(t.device.type, "cpu", False, t.nbytes)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _upload(src: torch.Tensor, dst: torch.Tensor, ring: _Ring) -> None:
    """Host ``src`` into the card's ``dst`` (both contiguous, one shape
    and dtype) through ``ring``: the host fills one buffer while the
    card reads the other."""
    src, dst = _bytes(src), _bytes(dst)
    n, chunk = src.numel(), ring.buffers[0].numel()
    for k, start in enumerate(range(0, n, chunk)):
        i, stop = k % 2, min(start + chunk, n)
        buf = ring.buffers[i][:stop - start]
        ring.wait(i)
        ring.host_copy(buf, src[start:stop])
        dst[start:stop].copy_(buf, non_blocking=True)
        ring.mark(i)


def _download(src: torch.Tensor, dst: torch.Tensor, ring: _Ring) -> None:
    """The card's ``src`` into host ``dst`` (both contiguous, one shape
    and dtype) through ``ring``: the card fills one buffer while the host
    empties the other."""
    src, dst = _bytes(src), _bytes(dst)
    n, chunk = src.numel(), ring.buffers[0].numel()
    starts = range(0, n, chunk)

    def fetch(k):  # enqueue chunk k's DMA into buffer k mod 2
        i = k % 2
        ring.wait(i)
        ring.buffers[i][:min(chunk, n - starts[k])].copy_(
            src[starts[k]:starts[k] + chunk], non_blocking=True)
        ring.mark(i)

    if starts:
        fetch(0)
    for k, start in enumerate(starts):
        if k + 1 < len(starts):
            fetch(k + 1)
        stop = min(start + chunk, n)
        ring.wait(k % 2)
        ring.host_copy(dst[start:stop], ring.buffers[k % 2][:stop - start])


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``: through the ring where :func:`upload_chunks` is
    not 0, the result then contiguous."""
    if not upload_chunks(t, device):
        return t.to(device)
    dst = torch.empty(t.shape, dtype=t.dtype, device=device)
    ring = _ring(dst.device)
    with ring.lock:
        _upload(t.contiguous(), dst, ring)
    return dst


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: through the ring where :func:`download_chunks` is not
    0, into a fresh pageable contiguous tensor."""
    if not download_chunks(t):
        return t.cpu()
    dst = torch.empty(t.shape, dtype=t.dtype)
    ring = _ring(t.device)
    with ring.lock:
        _download(t.contiguous(), dst, ring)
    return dst
