"""The staging ring of ``parallel/transfer.py``.

On the CPU the ring's schedule runs as the card runs it, with a ring of
plain CPU buffers and no events: the copies come out bit-equal to
``.to()`` / ``.cpu()`` for every size against the chunk (empty, under one
chunk, whole chunks, chunks and a remainder), every dtype the port moves
and a non-contiguous source; the plain path's conditions; and one ring
built per process and device. The tests marked ``cuda`` run the pinned
ring on the card and skip without one. The file imports no JAX, so on the
machine with the card it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_transfer.py
"""

import pytest
import torch

from pseudo_3d_interpolation_torch.parallel import transfer
from pseudo_3d_interpolation_torch.utils import timing

CHUNK = 4 * 4096  # bytes: the test ring's buffers, four pages
WORKERS = 3  # the test ring's threads: a chunk's host copy in two parts
DTYPES = [torch.float32, torch.complex64, torch.int32, torch.bool]
# bytes of the source: empty, under one chunk, whole chunks, and chunks
# with a remainder
SIZES = [0, CHUNK // 2, CHUNK, 3 * CHUNK, 3 * CHUNK + 8]


def seeded(nbytes: int, dtype, seed=0) -> torch.Tensor:
    """A seeded 1-D tensor of ``nbytes`` bytes, a multiple of its item."""
    g = torch.Generator().manual_seed(seed)
    n, rest = divmod(nbytes, torch.empty((), dtype=dtype).element_size())
    assert rest == 0
    if dtype == torch.bool:
        return torch.rand(n, generator=g) < 0.5
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                             dtype=torch.int32)
    return torch.randn(n, generator=g, dtype=dtype)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def assert_same(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.device == want.device and got.is_contiguous()
    assert torch.equal(bits(got), bits(want))


@pytest.fixture
def ring():
    """The ring the card's path runs, with CPU buffers of CHUNK bytes."""
    ring = transfer._Ring(torch.device("cpu"), CHUNK, WORKERS)
    yield ring
    ring.pool.shutdown()


@pytest.fixture
def staged_cpu(monkeypatch):
    """``to_device`` / ``to_host`` staged on the CPU: every copy of at
    least a CHUNK goes through a fresh CPU ring, into a fresh build
    registry."""
    monkeypatch.setattr(transfer, "CHUNK_BYTES", CHUNK)
    monkeypatch.setattr(transfer, "_RINGS", {})
    monkeypatch.setattr(timing, "BUILDS", timing.BuildRegistry())
    monkeypatch.setattr(
        transfer, "upload_chunks",
        lambda t, device: transfer._chunks("cuda", t.device.type, False,
                                           t.nbytes))
    monkeypatch.setattr(
        transfer, "download_chunks",
        lambda t: transfer._chunks("cuda", "cpu", False, t.nbytes))
    yield
    for ring in transfer._RINGS.values():
        ring.pool.shutdown()


@pytest.mark.parametrize("nbytes", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_upload_schedule_is_bit_equal(ring, nbytes, dtype):
    src = seeded(nbytes, dtype)
    dst = torch.empty_like(src)
    transfer._upload(src, dst, ring)
    assert_same(dst, src.to("cpu"))


@pytest.mark.parametrize("nbytes", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_download_schedule_is_bit_equal(ring, nbytes, dtype):
    src = seeded(nbytes, dtype, seed=1)
    dst = torch.empty_like(src)
    transfer._download(src, dst, ring)
    assert_same(dst, src.cpu())


@pytest.mark.parametrize("direction", ["to_device", "to_host"])
def test_non_contiguous_source_is_bit_equal(staged_cpu, direction):
    base = seeded(6 * CHUNK + 64, torch.float32, seed=2).reshape(-1, 8)
    src = base.t()[:, 1:]  # strided both ways
    assert not src.is_contiguous() and src.nbytes >= CHUNK
    if direction == "to_device":
        got = transfer.to_device(src, "cpu")
    else:
        got = transfer.to_host(src)
    assert_same(got, src.contiguous())
    assert timing.BUILDS.snapshot()["stage2.staging"]["count"] == 1


def test_second_copy_reuses_the_ring(staged_cpu):
    a = seeded(3 * CHUNK + 8, torch.complex64, seed=3)
    b = seeded(2 * CHUNK, torch.int32, seed=4)
    assert transfer.upload_chunks(a, "cpu") == 4
    assert transfer.download_chunks(b) == 2
    assert_same(transfer.to_device(a, "cpu"), a)
    (ring,) = transfer._RINGS.values()
    assert_same(transfer.to_host(b), b)
    assert_same(transfer.to_device(b, "cpu"), b)
    assert list(transfer._RINGS.values()) == [ring]
    assert timing.BUILDS.snapshot()["stage2.staging"]["count"] == 1


@pytest.mark.parametrize("case, args, chunks", [
    ("card, pageable, one chunk", ("cuda", "cpu", False, 1), 1),
    ("card, pageable, chunks and a remainder", ("cuda", "cpu", False, 3.5),
     4),
    ("CPU device", ("cpu", "cpu", False, 4), 0),
    ("under one chunk", ("cuda", "cpu", False, 0.5), 0),
    ("pinned source", ("cuda", "cpu", True, 4), 0),
    ("device-resident source", ("cuda", "cuda", False, 4), 0),
])
def test_plain_path_conditions(case, args, chunks):
    device_type, host_type, pinned, n = args
    assert transfer._chunks(device_type, host_type, pinned,
                            int(n * transfer.CHUNK_BYTES)) == chunks, case


@pytest.mark.parametrize("cores, cards, workers", [
    (8, 0, 8), (8, 1, 8), (32, 4, 8), (2, 4, 1)])
def test_ring_takes_a_cards_share_of_the_cores(monkeypatch, cores, cards,
                                               workers):
    """One process runs each card: the ring's threads are the cores over
    the host's cards, at least one."""
    monkeypatch.setattr(transfer.os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    monkeypatch.setattr(transfer.torch.cuda, "device_count", lambda: cards)
    assert transfer._workers() == workers


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_copies_take_the_plain_path(monkeypatch, dtype):
    """On the CPU, a tensor of several chunks is ``.to()`` / ``.cpu()``
    itself, and no ring is built."""
    monkeypatch.setattr(transfer, "CHUNK_BYTES", CHUNK)
    monkeypatch.setattr(transfer, "_RINGS", {})
    t = seeded(4 * CHUNK, dtype, seed=5)
    assert transfer.upload_chunks(t, "cpu") == 0
    assert transfer.download_chunks(t) == 0
    assert transfer.to_device(t, "cpu") is t
    assert transfer.to_host(t) is t
    assert transfer._RINGS == {}


# --- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pinned ring and its DMA)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_copies_are_bit_equal(card, dtype, extra):
    """Three chunks (and a remainder) up and down through the pinned
    ring, against ``.to()`` / ``.cpu()``."""
    src = seeded(3 * transfer.CHUNK_BYTES + extra, dtype, seed=6)
    assert transfer.upload_chunks(src, card) == 3 + (extra > 0)
    up = transfer.to_device(src, card)
    assert_same(up, src.to(card))
    assert transfer.download_chunks(up) == 3 + (extra > 0)
    assert_same(transfer.to_host(up), src)
    ring = transfer._RINGS[card]
    assert all(b.is_pinned() for b in ring.buffers)
    assert timing.BUILDS.snapshot()["stage2.staging"]["count"] == 1


@pytest.mark.cuda
def test_card_plain_paths(card):
    """A pinned source, a device-resident source and a small tensor take
    ``.to()`` / ``.cpu()``."""
    big = seeded(2 * transfer.CHUNK_BYTES, torch.float32, seed=7)
    pinned = big.pin_memory()
    assert transfer.upload_chunks(pinned, card) == 0
    assert_same(transfer.to_device(pinned, card), big.to(card))
    resident = big.to(card)
    assert transfer.upload_chunks(resident, card) == 0
    assert transfer.to_device(resident, card) is resident
    small = seeded(transfer.CHUNK_BYTES // 2, torch.float32, seed=8)
    assert transfer.upload_chunks(small, card) == 0
    assert transfer.download_chunks(small.to(card)) == 0
    assert_same(transfer.to_host(small.to(card)), small)


@pytest.mark.cuda
def test_card_upload_then_work_then_download_on_one_stream(card):
    """The ring's events order its reuse: back-to-back copies of
    different cubes, each changed on the card in between, come back
    right without a device synchronisation between them."""
    outs, want = [], []
    for seed in range(3):
        src = seeded(2 * transfer.CHUNK_BYTES + 8, torch.float32,
                     seed=10 + seed)
        up = transfer.to_device(src, card)
        outs.append(transfer.to_host(up * 2 + seed))
        want.append(src * 2 + seed)
    for got, w in zip(outs, want):
        assert_same(got, w)
