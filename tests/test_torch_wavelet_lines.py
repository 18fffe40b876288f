"""The wavelet solve's filter-pass schedule (``csrc/pocs_solve.cu``,
``wavelet_forward_kernel`` and ``wavelet_inverse_kernel``), on the CPU.

The kernel applies each level of the periodized Mallat cascade as a
strided circular filter of the wavelet's L taps, not as a product with the
dense nj×nj matrix. A forward block owns WT×WT coefficient positions of
each quadrant: it gathers the input region of rows and columns [2·r0,
2·r0 + 2·WT + L − 2), wrapped modulo the level's block side nj, filters it
along W into low and high columns (even and odd input columns apart), then
along H into low and high rows, shrinks the three detail quadrants with the
level's (cH, cV, cD) thresholds and stores all four. An inverse block owns
2·WT×2·WT output samples: it gathers the WT + L/2 − 1 low and as many high
coefficient rows and columns that reach them (wrapped modulo nj/2) and
filters along W, then along H, output 2i + s taking the taps L − 2 − 2p (s
even) or L − 1 − 2p (s odd) of coefficient i + p of the tile. The levels
alternate between the iterate's plane pair and one coefficient pair; level
0's inverse reinserts and sums the cost per tile, in tile order.

These tests replay that schedule with torch and hold it against the dense
``dwt_matrix`` cascade of ``pocs_solve_plain`` and the JAX package's
``pocs_solve_fused(basis='wavelet')`` in interpret mode, at db4 on 64² and
96² (blocks 96, 48, 24: tiles that overhang), coif5 on 256² and db20 on
160² at level 3, whose deepest block is exactly L = 40 (a tile's region is
longer than that block and wraps it); they also hold the tap extraction
that hands the kernel its filters to the matrices it replaces.

Tolerances: soft and garrote thresholds are continuous, so the schedule and
the matrix forms differ by float32 rounding of differently ordered sums,
held to 1e-5 of max (and √cost to 1e-6). Hard thresholds take thresholds in
a gap between the band's coefficient magnitudes (``gap_taus``), one
iteration from the observed slices, and are then held to the same bound."""

import numpy as np
import pytest
import torch
from torch_helpers import gap_taus

from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas.pocs_iter import pocs_solve_fused
from pseudo_3d_interpolation_torch.ops import wavelet as wv
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.ops.kernels.pocs_solve import _shrink

torch.set_num_threads(2)

TOL = 1e-5
SQRT_COST_ATOL = 1e-6
WT = 16  # the kernel's coefficient positions a tile side (csrc WT)
ALPHA = 0.75
# (n, wavelet): level 3 everywhere
CASES = [(64, "db4"), (96, "db4"), (256, "coif5"), (160, "db20")]
IDS = ["db4-64", "db4-96", "coif5-256", "db20-160"]


def _wrap(idx: torch.Tensor, m: int) -> torch.Tensor:
    return torch.remainder(idx, m)


def _forward_level(src, dst, lo, hi, nj, tau_b, op):
    """Forward level on the top-left nj×nj block of src (B, n, n) into dst,
    tile by tile; tau_b: (B, 3) thresholds (cH, cV, cD) of the level."""
    taps = len(lo)
    l2, s, h2 = taps // 2, 2 * WT + taps - 2, nj // 2
    tiles = -(-h2 // WT)
    for tr in range(tiles):
        for tc in range(tiles):
            r0, c0 = tr * WT, tc * WT
            ridx = _wrap(2 * r0 + torch.arange(s), nj)
            cidx = _wrap(2 * c0 + torch.arange(s), nj)
            region = src[:, ridx][:, :, cidx]  # (B, S, S)
            even, odd = region[..., 0::2], region[..., 1::2]
            low = torch.zeros(region.shape[:2] + (WT,), dtype=region.dtype)
            high = torch.zeros_like(low)
            for p in range(l2):  # along W, the kernel's tap order
                e, o = even[..., p:p + WT], odd[..., p:p + WT]
                low = low + lo[2 * p] * e + lo[2 * p + 1] * o
                high = high + hi[2 * p] * e + hi[2 * p + 1] * o
            mid = torch.cat([low, high], dim=-1)  # (B, S, 2·WT)
            rlo = torch.zeros(mid.shape[:1] + (WT, 2 * WT), dtype=mid.dtype)
            rhi = torch.zeros_like(rlo)
            for p in range(l2):  # along H
                v0 = mid[:, 2 * p:2 * p + 2 * WT:2]
                v1 = mid[:, 2 * p + 1:2 * p + 1 + 2 * WT:2]
                rlo = rlo + lo[2 * p] * v0 + lo[2 * p + 1] * v1
                rhi = rhi + hi[2 * p] * v0 + hi[2 * p + 1] * v1
            nr, nc = min(WT, h2 - r0), min(WT, h2 - c0)
            rows_lo = slice(r0, r0 + nr)
            rows_hi = slice(h2 + r0, h2 + r0 + nr)
            cols_lo = slice(c0, c0 + nc)
            cols_hi = slice(h2 + c0, h2 + c0 + nc)
            # (rows, columns, quadrant of the tile, band: -1 kept)
            for rows, cols, part, band in (
                    (rows_lo, cols_lo, rlo[:, :nr, :nc], -1),
                    (rows_lo, cols_hi, rlo[:, :nr, WT:WT + nc], 1),
                    (rows_hi, cols_lo, rhi[:, :nr, :nc], 0),
                    (rows_hi, cols_hi, rhi[:, :nr, WT:WT + nc], 2)):
                if band >= 0:
                    part = part * _shrink(part.real ** 2 + part.imag ** 2,
                                          tau_b[:, band, None, None], op)
                dst[:, rows, cols] = part


def _inverse_level(src, dst, lo, hi, nj):
    """Inverse level: the nj×nj coefficient block of src -> the top-left
    nj×nj block of dst, tile by tile; returns each tile's output (B,
    2·WT, 2·WT) cut to the block, in tile order, for level 0's sums."""
    taps = len(lo)
    l2, h2 = taps // 2, nj // 2
    u = WT + l2 - 1
    tiles = -(-h2 // WT)
    out = []
    for ti in range(tiles):
        for tj in range(tiles):
            i0, j0 = ti * WT, tj * WT
            k = torch.arange(u)
            ridx = torch.cat([_wrap(i0 - l2 + 1 + k, h2),
                              h2 + _wrap(i0 - l2 + 1 + k, h2)])
            cidx = torch.cat([_wrap(j0 - l2 + 1 + k, h2),
                              h2 + _wrap(j0 - l2 + 1 + k, h2)])
            cf = src[:, ridx][:, :, cidx]  # (B, S, S): low | high
            ev = torch.zeros(cf.shape[:2] + (WT,), dtype=cf.dtype)
            od = torch.zeros_like(ev)
            for p in range(l2):  # along W
                vl, vh = cf[..., p:p + WT], cf[..., u + p:u + p + WT]
                ev = ev + lo[taps - 2 - 2 * p] * vl + hi[taps - 2 - 2 * p] * vh
                od = od + lo[taps - 1 - 2 * p] * vl + hi[taps - 1 - 2 * p] * vh
            mid = torch.stack([ev, od], dim=-1).reshape(cf.shape[:2]
                                                        + (2 * WT,))
            ev = torch.zeros(mid.shape[:1] + (WT, 2 * WT), dtype=mid.dtype)
            od = torch.zeros_like(ev)
            for p in range(l2):  # along H
                vl, vh = mid[:, p:p + WT], mid[:, u + p:u + p + WT]
                ev = ev + lo[taps - 2 - 2 * p] * vl + hi[taps - 2 - 2 * p] * vh
                od = od + lo[taps - 1 - 2 * p] * vl + hi[taps - 1 - 2 * p] * vh
            tile = torch.stack([ev, od], dim=2).reshape(mid.shape[:1]
                                                        + (2 * WT, 2 * WT))
            nr, nc = min(2 * WT, nj - 2 * i0), min(2 * WT, nj - 2 * j0)
            tile = tile[:, :nr, :nc]
            dst[:, 2 * i0:2 * i0 + nr, 2 * j0:2 * j0 + nc] = tile
            out.append(((2 * i0, 2 * j0), tile))
    return out


def replay_solve(obs: Cplx, mask, decay, mats, op, version):
    """The kernel's solve: its init, per iteration the forward levels
    (finest first, P_lv -> P_lv+1), the inverse levels (deepest first,
    P_lv+1 -> P_lv), level 0's reinsertion with the cost summed per tile in
    tile order, and the state kernel's FPOCS update. Returns (x, cost)."""
    taps = ks.wavelet_taps(mats)
    ntap = taps.size // 2
    lo, hi = (float(t) for t in taps[:ntap]), (float(t) for t in taps[ntap:])
    lo, hi = list(lo), list(hi)
    z0 = torch.complex(obs.re, obs.im)
    b, n, _ = z0.shape
    level = len(mats)
    fast = version == "fast"
    keep = 1.0 - ALPHA * mask
    x, y = z0.clone(), z0.clone()
    t = torch.zeros_like(z0)
    v = torch.ones(b)
    cprev = torch.full((b,), float("inf"))
    cost = cprev.clone()
    for j in range(decay.shape[0]):
        planes = [y, t]
        for lv in range(level):
            d = level - 1 - lv
            _forward_level(planes[lv & 1], planes[(lv + 1) & 1], lo, hi,
                           n >> lv, decay[j, :, 3 * d:3 * d + 3], op)
        for lv in range(level - 1, 0, -1):
            _inverse_level(planes[(lv + 1) & 1], planes[lv & 1], lo, hi,
                           n >> lv)
        rec = torch.zeros_like(z0)
        tiles = _inverse_level(t, rec, lo, hi, n)
        new = rec * keep + ALPHA * z0
        s = torch.zeros(b)
        dsum = torch.zeros(b)
        for (r, c), tile in tiles:  # the blocks' partial sums, in order
            sel = (slice(None), slice(r, r + tile.shape[1]),
                   slice(c, c + tile.shape[2]))
            mag = new[sel].abs()
            s = s + mag.sum(dim=(-2, -1))
            dsum = dsum + (mag - x[sel].abs()).sum(dim=(-2, -1))
        cost = dsum * dsum / torch.where(s == 0, torch.ones_like(s), s * s)
        v1 = (1.0 + torch.sqrt(1.0 + 4.0 * v * v)) / 2.0
        restart = (cost > cprev) & fast
        v_next = torch.where(restart, torch.ones_like(v1), v1)
        v1_next = (1.0 + torch.sqrt(1.0 + 4.0 * v_next * v_next)) / 2.0
        f = (v_next - 1.0) / (v1_next + 1.0) if fast else torch.zeros(b)
        prev = torch.where(restart[:, None, None], new, x)
        x = new
        y = new + f[:, None, None] * (new - prev)
        v, cprev = v_next, cost
    return Cplx(x.real.contiguous(), x.imag.contiguous()), cost


def _inputs(n, name, niter, seed, hard=False):
    """(obs, mask, decay, mats): two slices of plane waves under a 50%
    column mask, the level-3 matrices, and per-band thresholds (drawn from
    the band magnitudes; with ``hard`` one iteration in gaps of the
    observed slices' band magnitudes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    truth = np.zeros((2, n, n), np.complex64)
    for i in range(2):
        for _ in range(4):
            fy, fx = rng.integers(1, 12, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / n + fx * xx / n)
                + 1j * rng.uniform(0, 6.28))
    mask = (rng.uniform(size=n) < 0.5)[None, :].repeat(n, 0)
    obs = (truth * mask).astype(np.complex64)
    mats = [wv.dwt_matrix(n >> j, name) for j in range(3)]
    fwd = ks._plain_basis("wavelet", n, n, "cpu", mats)[0]
    coef = fwd(torch.from_numpy(obs)).numpy()
    bands = []
    for d in range(3):
        s = n >> (3 - d)
        bands += [coef[:, s:2 * s, :s], coef[:, :s, s:2 * s],
                  coef[:, s:2 * s, s:2 * s]]
    if hard:
        tau = np.stack([gap_taus(np.abs(bd).reshape(2, 1, -1))[:, 0]
                        for bd in bands], axis=-1)[None]
    else:
        scale = np.stack([np.abs(bd).max(axis=(-2, -1)) for bd in bands], -1)
        tau = (scale[None] * rng.uniform(0.05, 0.4, size=(niter, 2, 9)))
    pair = Cplx(torch.from_numpy(np.ascontiguousarray(obs.real)),
                torch.from_numpy(np.ascontiguousarray(obs.imag)))
    return (pair, torch.from_numpy(mask.astype(np.float32)),
            torch.from_numpy(tau.astype(np.float32)).contiguous(), mats)


def _close(got: Cplx, want):
    got = np.asarray(got.re) + 1j * np.asarray(got.im)
    want = np.asarray(want.re) + 1j * np.asarray(want.im)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max() / scale
    assert err <= TOL, err


@pytest.mark.parametrize("op,version,niter", [("soft", "fast", 3),
                                              ("garrote", "regular", 3),
                                              ("hard", "regular", 1)])
@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_filter_schedule_matches_plain(n, name, op, version, niter):
    obs, mask, decay, mats = _inputs(n, name, niter, seed=n,
                                     hard=op == "hard")
    got, cost = replay_solve(obs, mask, decay, mats, op, version)
    before = ks.pocs_solve.launches_by_basis["wavelet"]
    want, want_cost = ks.pocs_solve(obs, mask, decay, ALPHA, op, version,
                                    basis="wavelet", wavelet_mats=mats)
    assert ks.pocs_solve.launches_by_basis["wavelet"] == before  # plain
    _close(got, want)
    np.testing.assert_allclose(cost.sqrt().numpy(), want_cost.sqrt().numpy(),
                               rtol=0, atol=SQRT_COST_ATOL)


@pytest.mark.parametrize("op,version,niter", [("soft", "fast", 2),
                                              ("hard", "regular", 1)])
@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_filter_schedule_matches_jax_kernel(n, name, op, version, niter):
    obs, mask, decay, mats = _inputs(n, name, niter, seed=2 * n,
                                     hard=op == "hard")
    want, _ = pocs_solve_fused(
        JCplx(obs.re.numpy(), obs.im.numpy()), mask.numpy(), decay.numpy(),
        alpha=ALPHA, thresh_op=op, version=version, interpret=True,
        basis="wavelet", wavelet_mats=mats)
    got, _ = replay_solve(obs, mask, decay, mats, op, version)
    _close(got, want)


def test_deepest_db20_tile_wraps_its_block():
    """db20 at 160², level 3: the deepest block is 40 = L, so a forward
    tile's region of 2·WT + L − 2 = 70 rows is longer than the block and
    an inverse tile's WT + L/2 − 1 = 35 low rows longer than its 20 low
    rows, starting below 0: the replay's true modulo keeps every index in
    the block and reaches each of its rows."""
    taps = ks.wavelet_taps([wv.dwt_matrix(160 >> j, "db20")
                            for j in range(3)])
    ntap = taps.size // 2
    assert ntap == 40 and 160 >> 2 == ntap
    ridx = _wrap(torch.arange(2 * WT + ntap - 2), 40)
    assert ridx.bincount().min() >= 1 and ridx.bincount().max() == 2
    assert int(ridx.max()) == 39
    low = _wrap(-ntap // 2 + 1 + torch.arange(WT + ntap // 2 - 1), 20)
    assert low.bincount().min() >= 1 and low.bincount().max() == 2
    assert int(low.max()) == 19


@pytest.mark.parametrize("name", ["haar", "db4", "sym8", "coif5", "db20"])
def test_taps_are_the_filters_of_the_matrices(name):
    n = 4 * wv.filter_length(name) + 8
    n -= n % 8
    mats = [wv.dwt_matrix(n >> j, name) for j in range(3)]
    taps = ks.wavelet_taps(mats)
    h, g, _, _ = wv.wavelet_filters(name)
    np.testing.assert_array_equal(taps, np.concatenate([h, g]))
    assert ks.wavelet_taps(mats) is taps  # checked once per matrix set
    on = [wv.dwt_matrix_on(n >> j, name, "cpu") for j in range(3)]
    assert ks.wavelet_taps(on) is ks.wavelet_taps(on)


def _not_periodized():
    """Matrix sets that are not the periodized filter cascade."""
    good = [wv.dwt_matrix(64 >> j, "db4") for j in range(3)]
    moved = good[0].copy()
    moved[5, 12] += 0.25  # one entry off the filter pattern
    other = [good[0], wv.dwt_matrix(32, "db2"), good[2]]  # another wavelet
    q, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(64, 64)))
    return {"one-entry": [moved, good[1], good[2]],
            "mixed-wavelets": other,
            "dense-orthogonal": [q.astype(np.float32), good[1], good[2]],
            "zero": [np.zeros((64, 64), np.float32), good[1], good[2]]}


@pytest.mark.parametrize("case", ["one-entry", "mixed-wavelets",
                                  "dense-orthogonal", "zero"])
def test_taps_refuse_a_matrix_that_is_not_a_periodized_filter(case):
    mats = _not_periodized()[case]
    with pytest.raises(ValueError):
        ks.wavelet_taps(mats)
    z = torch.zeros(1, 64, 64)
    with pytest.raises(ValueError):
        ks.pocs_solve(Cplx(z, z), torch.ones(64, 64), torch.ones(2, 1, 9),
                      basis="wavelet", wavelet_mats=mats)


def test_taps_refuse_a_cascade_deeper_than_the_filter():
    """db20's 40 taps on 64²: the level-1 block of 32 is shorter than the
    filter (dwt_matrix refuses it; a coarser matrix in its place is
    refused here)."""
    mats = [wv.dwt_matrix(64, "db20"), wv.dwt_matrix(32, "db4")]
    with pytest.raises(ValueError, match="shorter than the filter"):
        ks.wavelet_taps(mats)


def test_wavelet_scratch_follows_the_tiles():
    """The wavelet solve's scratch: two plane pairs and one partial-sum
    pair per level-0 inverse tile (2·WT = 32 samples a side): 256 tiles at
    512², 9 at 96², 25 at 160², 4 at 64²."""
    for n, tiles in ((512, 256), (96, 9), (160, 25), (64, 4)):
        got = ks.solve_work_floats(3, n, n, "wavelet")
        assert got == 2 * 2 * 3 * n * n + 2 * 3 * tiles + 4 * 3
