"""SHEARLET and CURVELET with percentile thresholds: the port's solves
against the JAX package's, the split route's schedule in its plain
versions, and a torch replay of the selection kernel's radix select.

On the card a ``*-percentile`` threshold runs the subband kernels split at
the threshold (``ops/kernels/subband.py``: pass 1 writes |c| of every
band, ``ops/kernels/percentile.band_percentile`` selects one threshold per
(slice, band), pass 2 shrinks). Here, on CPU tensors, every wrapper of
that schedule takes its plain version, and the solver takes the plain
streamed apply, which is the JAX package's route for these thresholds
(its plain XLA apply, ``threshold_pair`` with a percentile kind).

Tolerances: soft and garrote solves within 1.5e-6·max of the JAX
package's on SHEARLET, with equal iteration counts (fp32 rounding of two
FFT libraries over 10-25 iterations; the percentile's rank is a float32
place apart where XLA reassociates q/100·(n−1), which moves a soft
threshold by about 1e-7 of the coefficients). CURVELET within 1e-5·max,
its tolerance from the start; it does not drift from the JAX package
faster than SHEARLET: both drift alike, growing with the iterations
(fp32 rounding of two FFT libraries; at 130×70, 2 slices, FPOCS with
plain thresholds, after 1, 5 and 20 iterations the solves are 9.8e-8,
1.2e-6 and 7.0e-6 of max apart on SHEARLET with garrote, 2.2e-7, 1.7e-6
and 8.0e-6 on CURVELET; with soft 4.9e-8, 1.2e-6, 4.9e-6 and 1.1e-7,
1.1e-6, 6.4e-6). A hard percentile threshold lands on a
coefficient by construction, so a reordered sum flips it: hard solves are
held by SNR against the dense truth, within 0.05 dB of the JAX package's.
The split schedule replayed through ``_pocs_subband_apply_kernels`` takes
the box spectra from the top-level spectrum where the streamed route takes
a partial fft2 of the iterate (the same linear maps): soft and garrote
within 1e-5·max there, hard with at most 2e-3 of the elements beyond
3e-4·max. The radix replays and the selection are bit-equal to the
port's ``_percentile_from_mag``, the selection kernel's specification. The
JAX package's ``_percentile_from_mag`` is not reproducible bit for bit by
float32 steps: its XLA CPU code contracts the weighted sum into a fused
multiply-add and reassociates the rank (on 300 random q over 1480 keys
its result matched the unfused form 198 times and an FMA'd one 250), so
the replay of the selection kernel is held to it in two parts: the two
order statistics it selects bit-equal to the JAX package's sort of the
keys, and the threshold within 1e-5 relative of its result, the
tolerance ``test_torch_percentile.py`` holds per-slice percentiles to."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.ops import threshold as jthreshold
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops import shearlet as sh
from pseudo_3d_interpolation_torch.ops import threshold
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import percentile as kp
from pseudo_3d_interpolation_torch.ops.kernels import subband as ksb
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

SOFT_TOL = {"SHEARLET": 1.5e-6, "CURVELET": 1e-5}
SNR_TOL_DB = 0.05
ROUTE_TOL = 1e-5
OUTLIER = 3e-4
OUTLIER_SHARE = 2e-3
META = dict(thresh_model="exponential", decay_kind="factors", p_max=99.9,
            p_min=60.0, version="fast", alpha=0.75, eps=0.0)
OPS = ("hard-percentile", "soft-percentile", "garrote-percentile")
SHAPES = ((128, 128), (96, 128), (130, 70))


def _truth(f, h, w, seed=0):
    """Sums of a few plane waves per slice: sparse in every basis."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((f, h, w), np.complex64)
    for i in range(f):
        for _ in range(4):
            fy, fx = rng.integers(1, 12, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 2 * np.pi))
    return truth


def _snr(truth, x):
    return 10 * np.log10(np.sum(np.abs(truth) ** 2)
                         / np.sum(np.abs(x - truth) ** 2))


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


# every basis on every shape with every threshold, the mask alternating
# between one shared 2-D mask and one mask per slice
SOLVES = [(kind, shape, op, (i + j) % 2 == 1, 2 + (i + j) % 3,
           10 + 5 * ((i + 2 * j) % 4))
          for kind in ("SHEARLET", "CURVELET")
          for i, shape in enumerate(SHAPES) for j, op in enumerate(OPS)]


@pytest.mark.parametrize(
    "kind,shape,op,per_slice,f,niter", SOLVES,
    ids=[f"{k}-{h}x{w}-{op}-{'per-slice' if p else 'shared'}-mask"
         for k, (h, w), op, p, _, _ in SOLVES])
def test_solve_matches_jax(kind, shape, op, per_slice, f, niter):
    h, w = shape
    truth = _truth(f, h, w, seed=h + w + f)
    rng = np.random.default_rng(niter)
    mshape = (f, h, w) if per_slice else (h, w)
    mask = (rng.uniform(size=mshape) < 0.55).astype(np.float32)
    obs = truth * mask
    meta = dict(META, niter=niter, thresh_op=op, transform_kind=kind)
    rt = pocs.solver_route((f, h, w), mshape, pocs.POCSConfig(**meta))
    assert (rt.route, pocs.runs(rt)) == ("streamed-subband", True)
    jres = jpocs.pocs_interpolate(
        JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag)),
        jnp.asarray(mask), jget(kind), jpocs.POCSConfig(**meta))
    res = pocs.pocs_interpolate(
        Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy())),
        torch.from_numpy(mask), get_transform(kind), pocs.POCSConfig(**meta))
    got, want = _np(res.data), _np(jres.data)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(res.n_iterations.numpy(),
                                  np.asarray(jres.n_iterations))
    if op == "hard-percentile":
        assert abs(_snr(truth, got) - _snr(truth, want)) <= SNR_TOL_DB
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= SOFT_TOL[kind] * scale


def _cubes(obs, mask):
    coords = {"iline": np.arange(obs.shape[1]),
              "xline": np.arange(obs.shape[2]),
              "freq": np.arange(obs.shape[0], dtype=np.float64)}
    data_vars = {"amp": (("iline", "xline", "freq"),
                         np.ascontiguousarray(np.moveaxis(obs, 0, -1))),
                 "fold": (("iline", "xline"), mask.astype(np.int32))}
    return (JCube(coords=dict(coords), data_vars=dict(data_vars)),
            Cube(coords=dict(coords), data_vars=dict(data_vars)))


@pytest.mark.parametrize("kind", ["SHEARLET", "CURVELET"])
def test_interpolate_matches_jax(kind):
    """The cube driver on the CPU: ``interpolate`` with a percentile
    threshold in the production configuration (the basis's driver
    precision) against the JAX package's driver."""
    f, h, w = 3, 96, 96
    truth = _truth(f, h, w, seed=5)
    mask = (np.random.default_rng(6).uniform(size=(h, w)) < 0.6
            ).astype(np.float32)
    jcube, cube = _cubes(truth * mask, mask)
    meta = dict(META, niter=10, thresh_op="soft-percentile",
                transform_kind=kind)
    want = jpipe.interpolate(jcube, {"metadata": meta}, mesh=make_mesh(1),
                             batch=4).data_vars["amp_interp"][1]
    got = pipe.interpolate(cube, {"metadata": meta}, batch=4,
                           device="cpu").data_vars["amp_interp"][1]
    assert got.shape == want.shape
    # the production 'high' is bf16x3 in JAX and fp32 here: by SNR
    assert abs(_snr(np.moveaxis(truth, 0, -1), got)
               - _snr(np.moveaxis(truth, 0, -1), want)) <= 0.1


def _case(kind, h, w, b=2, seed=3):
    truth = _truth(b, h, w, seed)
    mask = (np.random.default_rng(seed).uniform(size=(h, w)) < 0.6)
    obs = (truth * mask).astype(np.complex64)
    z = Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy()))
    plan = get_transform(kind)._plan(h, w)
    nbands = sum(g.psi.shape[0] for g in plan)
    q = torch.from_numpy(np.random.default_rng(seed).uniform(
        60.0, 99.9, size=(b, nbands)).astype(np.float32))
    return z, plan, q


@pytest.mark.parametrize("kind,shape", [("SHEARLET", (256, 256)),
                                        ("SHEARLET", (96, 128)),
                                        ("CURVELET", (256, 256)),
                                        ("CURVELET", (130, 70))])
@pytest.mark.parametrize("op", OPS)
def test_split_schedule_matches_streamed(kind, shape, op):
    """The split route's plain versions (pass 1's keys, the selection, pass
    2) driven through the kernel route on CPU tensors, box groups included
    at 256², against the plain streamed apply."""
    z, plan, q = _case(kind, *shape)
    want = _np(sh._pocs_subband_apply_streamed(z, plan, q, op))
    got = _np(sh._pocs_subband_apply_kernels(z, plan, q, op, "highest",
                                             "highest"))
    scale = np.abs(want).max()
    err = np.abs(got - want)
    if op == "hard-percentile":
        assert np.mean(err > OUTLIER * scale) <= OUTLIER_SHARE
    else:
        assert err.max() <= ROUTE_TOL * scale


def test_split_schedule_box_groups_present():
    """The 256² plans carry box groups, so the schedule test above drives
    box_keys and box_shrink too."""
    for kind in ("SHEARLET", "CURVELET"):
        boxes = sh._plan_kernel_pack(get_transform(kind)._plan(256, 256),
                                     256, 256)[2]
        if kind == "SHEARLET":
            assert len(boxes) == 2


@pytest.mark.parametrize("op", OPS)
def test_band_chunks_sum_like_one_chunk(monkeypatch, op):
    """Pass 2 sums each chunk onto the accumulator in band order, so the
    chunked schedule equals the one-chunk schedule bit for bit."""
    z, plan, q = _case("SHEARLET", 128, 128)
    full, full_idx, _ = sh._plan_kernel_pack(plan, 128, 128)
    xf = torch.fft.fft2(torch.complex(z.re, z.im))
    spec = Cplx(xf.real.contiguous(), xf.imag.contiguous())
    psi = full.psi_on("cpu")
    qf = q[:, torch.from_numpy(full_idx)].contiguous()
    support = ksb.row_support_on(full.psi, "cpu")
    one = ksb.subband_update_percentile(spec, psi, qf, op, support=support)
    assert len(support.chunks(2, 128, 128)[0]) == 2
    monkeypatch.setattr(ksb, "SCRATCH_BYTES", 2 * 128 * 128 * 8 * 3)
    support = ksb.row_support_on(full.psi, "cpu")
    assert len(support.chunks(2, 128, 128)[0]) > 3
    many = ksb.subband_update_percentile(spec, psi, qf, op, support=support)
    assert torch.equal(one.re, many.re) and torch.equal(one.im, many.im)
    plain = ksb.subband_update_percentile_plain(spec, psi, qf, op)
    assert torch.equal(one.re, plain.re) and torch.equal(one.im, plain.im)


def test_keys_are_the_magnitudes_jax_thresholds():
    """Pass 1's keys are |c| of the full field as ``Cplx.abs`` rounds it:
    the full-size bands' ifft2(X·ψ_l), and a box group's whole
    N_h × N_w field, not its box."""
    z, plan, q = _case("SHEARLET", 256, 256)
    h = w = 256
    full, _, boxes = sh._plan_kernel_pack(plan, h, w)
    xf = torch.fft.fft2(torch.complex(z.re, z.im))
    spec = Cplx(xf.real.contiguous(), xf.imag.contiguous())
    psi = full.psi_on("cpu")
    keys, _ = ksb.subband_keys(spec, psi, full.support_on("cpu"), 3, 7)
    assert keys.shape == (2, 4, h, w)
    c = torch.fft.ifft2(xf * psi[5])
    assert torch.equal(keys[:, 2], Cplx(c.real.contiguous(),
                                        c.imag.contiguous()).abs())
    _, lg, g = boxes[1]
    ih, iw = g.index_on("cpu")
    box = xf[:, ih[:, None], iw[None, :]]
    bkeys, _ = ksb.box_keys(Cplx(box.real.contiguous(),
                                 box.imag.contiguous()),
                            g.psi_on("cpu"), g.box_mats_on(h, w, "cpu"), h, w)
    assert bkeys.shape == (2, lg, h, w)
    ah, aw = g.partial_on(h, w, "cpu")
    c = sh._partial_ifft2(box * g.psi_on("cpu")[1], ah, aw)
    assert torch.equal(bkeys[:, 1], Cplx(c.real.contiguous(),
                                         c.imag.contiguous()).abs())


# --- the selection kernel's radix select, replayed with torch ----------

def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order_key: float32 bits as an unsigned order, held in
    int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (u & 0x80000000) != 0
    return torch.where(neg, (~u) & 0xFFFFFFFF, u | 0x80000000)


def _from_order(k: int) -> float:
    u = (k & 0x7FFFFFFF) if k & 0x80000000 else (~k) & 0xFFFFFFFF
    return torch.tensor([u], dtype=torch.int64).to(torch.int32).view(
        torch.float32).item()


def _radix_select(seg: torch.Tensor, q: float) -> torch.Tensor:
    """One segment's percentile by three digit passes over all its keys,
    as the selection kernel's finishing block runs digits 2 and 3 over the
    keys of a segment past the candidates' capacity: the rank and weights
    in float32, three digit passes (11, 11 and 10 bits from the top) over
    the keys matching the digits chosen so far, each picking the bin that
    holds the rank, then the least key above when the rank after it leaves
    the run of equal keys."""
    n = seg.numel()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    top = f32(float(np.float32(n) - np.float32(1)))
    pos = f32(q) / f32(100.0) * top
    lo_f, hi_f = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo_f
    lw = f32(1.0) - hw
    lo = min(int(torch.clamp(lo_f, 0, top)), n - 1)
    hi = min(int(torch.clamp(hi_f, 0, top)), n - 1)
    keys = _order_keys(seg.reshape(-1))
    prefix, mask, rank, equal = 0, 0, lo, 0
    for shift, width in ((21, 11), (10, 11), (0, 10)):
        bins = 1 << width
        hit = keys[(keys & mask) == prefix]
        hist = torch.bincount((hit >> shift) & (bins - 1), minlength=bins)
        cum = torch.cumsum(hist, 0)
        digit = int(torch.searchsorted(cum, rank, right=True))
        rank -= int(cum[digit] - hist[digit])
        prefix |= digit << shift
        mask |= (bins - 1) << shift
        equal = int(hist[digit])
    v_lo = f32(_from_order(prefix))
    v_hi = v_lo
    if hi > lo and rank + 1 >= equal:
        v_hi = f32(_from_order(int(keys[keys > prefix].min())))
    if bool(torch.isnan(seg).any()):
        return f32(float("nan"))
    return v_lo * lw + v_hi * hw


def _ranks(n: int, q: float):
    """(lo, hi, low weight, high weight) as the kernel rounds them."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    top = f32(float(np.float32(n) - np.float32(1)))
    pos = f32(q) / f32(100.0) * top
    lo_f, hi_f = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo_f
    return (min(int(torch.clamp(lo_f, 0, top)), n - 1),
            min(int(torch.clamp(hi_f, 0, top)), n - 1), f32(1.0) - hw, hw)


def _digits(src: torch.Tensor, prefix: int, rank: int, equal: int):
    """Digits 2 and 3 (11 and 10 bits) over the order keys ``src`` whose
    first digit is ``prefix``'s: (prefix, rank, equal) after them, as the
    finishing block's passes leave them."""
    mask = 0xFFE00000
    for shift, width in ((10, 11), (0, 10)):
        bins = 1 << width
        hit = src[(src & mask) == prefix]
        hist = torch.bincount((hit >> shift) & (bins - 1), minlength=bins)
        cum = torch.cumsum(hist, 0)
        digit = int(torch.searchsorted(cum, rank, right=True))
        rank -= int(cum[digit] - hist[digit])
        prefix |= digit << shift
        mask |= (bins - 1) << shift
        equal = int(hist[digit])
    return prefix, rank, equal


def _select_replay(seg: torch.Tensor, q: float, cap: int | None = None,
                   seed: int = 0):
    """One segment's percentile as the selection kernel computes it from
    pass 1's histogram (``key_histogram_plain``): the plan (the first
    digit whose bin holds rank lo, the rank inside the bin, whether rank
    hi lies past the bin), the gather (the bin's keys compacted in no
    fixed order, shuffled here as the warps' appends may order them, and
    the least key above the bin when rank hi lies past it), the finish
    (digits 2 and 3 over the candidates, or over all the keys when the bin
    holds more than ``cap``). Returns (t, the two order statistics, None
    for a segment holding a NaN)."""
    n = seg.numel()
    cap = kp.candidate_capacity(n) if cap is None else cap
    lo, hi, lw, hw = _ranks(n, q)
    hist = kp.key_histogram_plain(seg.reshape(1, 1, -1))[0].to(torch.int64)
    if int(hist[kp.KEY_BINS]) > 0:
        return torch.tensor(float("nan")), None
    keys = kp.order_keys(seg.reshape(-1))
    cum = torch.cumsum(hist[:kp.KEY_BINS], 0)
    d = int(torch.searchsorted(cum, lo, right=True))
    rank, count = lo - int(cum[d] - hist[d]), int(hist[d])
    past_bin = hi > lo and rank + 1 >= count
    first = keys >> 21
    above_bin = int(keys[first > d].min()) if past_bin else None
    if count <= cap:
        gen = torch.Generator().manual_seed(seed)
        src = keys[first == d]
        src = src[torch.randperm(src.numel(), generator=gen)]
    else:
        src = keys
    prefix, rank, equal = _digits(src, d << 21, rank, count)
    v_lo = torch.tensor(_from_order(prefix), dtype=torch.float32)
    v_hi = v_lo
    if hi > lo and rank + 1 >= equal:
        v_hi = torch.tensor(_from_order(
            above_bin if past_bin else int(src[src > prefix].min())),
            dtype=torch.float32)
    return v_lo * lw + v_hi * hw, (v_lo, v_hi)


def _reference(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``_percentile_from_mag`` through its sort (the per-row path)."""
    return kp.band_percentile_plain(keys, q)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit-equal where ``want`` is a number, NaN where it is NaN."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


SELECT_CASES = {
    "uniform": (lambda r: r.uniform(size=(3, 2, 40, 37)), [37.5, 99.9]),
    "ties": (lambda r: np.round(r.uniform(size=(2, 3, 16, 16)) * 5),
             [0.0, 50.0, 73.3]),
    "q 0 and 100": (lambda r: r.exponential(size=(2, 2, 31, 33)),
                    [0.0, 100.0]),
    "q outside": (lambda r: r.uniform(size=(2, 2, 8, 9)), [-5.0, 150.0]),
    "integer ranks": (lambda r: r.uniform(size=(1, 4, 10, 10)),
                      [100.0 * k / 99.0 for k in (0, 1, 50, 98)]),
    "zeros": (lambda r: np.zeros((1, 2, 6, 7)), [60.0, 99.0]),
    "heavy tail": (lambda r: r.pareto(0.7, size=(2, 2, 64, 64)),
                   [60.0, 99.9]),
    # every key inside one first digit (an exponent's first quarter)
    "one first digit": (lambda r: 1.0 + 0.25 * r.uniform(size=(2, 2, 30, 30)),
                        [0.0, 37.5, 60.0, 99.9]),
    "all equal": (lambda r: np.full((2, 2, 17, 19), 0.37),
                  [0.0, 60.0, 99.9, 100.0]),
    # half the keys in [1, 1.25) and half in [4, 5): at q 50 rank lo is
    # the last key of its first-digit bin and rank hi the first of the next
    "rank lo last of its bin": (
        lambda r: np.concatenate([1.0 + 0.25 * r.uniform(size=(2, 1, 50)),
                                  4.0 + r.uniform(size=(2, 1, 50))],
                                 axis=-1).reshape(2, 1, 10, 10), [50.0]),
    "NaN segment": (
        lambda r: np.where(np.arange(2 * 3 * 8 * 8).reshape(2, 3, 8, 8) == 77,
                           np.nan, r.uniform(size=(2, 3, 8, 8))),
        [80.0, 25.0]),
}


@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_radix_replay_bit_equal(name):
    make, qs = SELECT_CASES[name]
    rng = np.random.default_rng(len(name))
    keys = torch.from_numpy(make(rng).astype(np.float32))
    s, c = keys.shape[:2]
    q = torch.tensor([qs[(i + j) % len(qs)] for i in range(s)
                      for j in range(c)], dtype=torch.float32).reshape(s, c)
    want = _reference(keys, q)
    got = torch.stack([_radix_select(keys[i, j], float(q[i, j]))
                       for i in range(s) for j in range(c)]).reshape(s, c)
    assert _same_bits(got, want)


def _select_case(name):
    """(keys (S, C, H, W) float32 numpy, q (S, C) float32 numpy) of a
    SELECT_CASES entry, seeded by its name."""
    make, qs = SELECT_CASES[name]
    rng = np.random.default_rng(len(name))
    keys = make(rng).astype(np.float32)
    s, c = keys.shape[:2]
    q = np.array([qs[(i + j) % len(qs)] for i in range(s) for j in range(c)],
                 np.float32).reshape(s, c)
    return keys, q


@pytest.mark.parametrize("capacity", ["half", "none"])
@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_replay_matches_jax(name, capacity):
    """The selection kernel's design replayed with torch on the same seeded
    numpy keys as the JAX package's ``_percentile_from_mag``: bit-equal to
    the port's plain version, its two order statistics bit-equal to the
    JAX package's sort, the threshold within 1e-5 relative of JAX's (XLA's
    fused weighted sum, see the module's docstring); with the candidate
    buffer of half a segment, and with none (every segment finished over
    its keys)."""
    keys, q = _select_case(name)
    s, c, h, w = keys.shape
    cap = None if capacity == "half" else 0
    got, stats = [], []
    for i in range(s):
        for j in range(c):
            t, pair = _select_replay(torch.from_numpy(keys[i, j]),
                                     float(q[i, j]), cap, seed=i * c + j)
            got.append(t)
            stats.append(pair)
    got = torch.stack(got).reshape(s, c)
    assert _same_bits(got, _reference(torch.from_numpy(keys),
                                      torch.from_numpy(q)))
    want = np.asarray(jthreshold._percentile_from_mag(
        jnp.asarray(keys), jnp.asarray(q)))[..., 0, 0]
    assert np.array_equal(np.isnan(want), torch.isnan(got).numpy())
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-5, atol=0)
    ordered = np.asarray(jnp.sort(jnp.asarray(keys.reshape(s * c, -1)),
                                  axis=-1))
    for k, pair in enumerate(stats):
        if pair is None:
            continue
        lo, hi, _, _ = _ranks(h * w, float(q.reshape(-1)[k]))
        assert pair[0].item() == ordered[k, lo].item()
        assert pair[1].item() == ordered[k, hi].item()


def _jax_keys(h, w, bands, seed):
    """|c| of ``bands`` windowed bands of a seeded spectrum, computed by
    the JAX package (its ``Cplx.abs`` of ``jnp.fft.ifft2``), as numpy."""
    rng = np.random.default_rng(seed)
    spec = (rng.normal(size=(2, h, w)) + 1j * rng.normal(size=(2, h, w))
            ).astype(np.complex64)
    psi = (rng.uniform(size=(bands, h, w))
           * (rng.uniform(size=(bands, h, 1)) < 0.5)).astype(np.float32)
    c = jnp.fft.ifft2(jnp.asarray(spec)[:, None] * jnp.asarray(psi)[None])
    return np.array(JCplx(jnp.real(c), jnp.imag(c)).abs())


def test_key_histogram_plain_is_numpy_histogram():
    """The first-digit histogram pass 1 counts (its plain version) is
    ``np.histogram`` of the keys' top 11 order-key bits, on keys the JAX
    package computes; its last column counts NaNs."""
    keys = _jax_keys(24, 20, 3, seed=11)
    keys[1, 2, 5, 7] = np.nan
    hist = kp.key_histogram_plain(torch.from_numpy(keys)).numpy()
    assert hist.shape == (2, 3, kp.HIST_COLS) and hist.dtype == np.int32
    bits = keys.view(np.uint32).astype(np.int64)
    order = np.where(bits >= 1 << 31, ~bits & 0xFFFFFFFF, bits | 1 << 31)
    for i in range(2):
        for j in range(3):
            want, _ = np.histogram(order[i, j] >> 21,
                                   bins=np.arange(kp.KEY_BINS + 1))
            np.testing.assert_array_equal(hist[i, j, :kp.KEY_BINS], want)
            assert hist[i, j, kp.KEY_BINS] == np.isnan(keys[i, j]).sum()
    assert hist[1, 2, kp.KEY_BINS] == 1 and hist[..., kp.KEY_BINS].sum() == 1


def test_keys_histogram_on_the_host_is_pass_1s():
    """On CPU tensors ``subband_keys`` and ``box_keys`` return the plain
    histogram of the keys they return beside them."""
    z, plan, q = _case("SHEARLET", 256, 256)
    h = w = 256
    full, _, boxes = sh._plan_kernel_pack(plan, h, w)
    xf = torch.fft.fft2(torch.complex(z.re, z.im))
    spec = Cplx(xf.real.contiguous(), xf.imag.contiguous())
    keys, hist = ksb.subband_keys(spec, full.psi_on("cpu"),
                                  full.support_on("cpu"), 2, 5)
    assert hist.shape == (2, 3, kp.HIST_COLS) and hist.dtype == torch.int32
    assert torch.equal(hist, kp.key_histogram_plain(keys))
    assert int(hist[..., :kp.KEY_BINS].sum()) == 2 * 3 * h * w
    _, lg, g = boxes[0]
    ih, iw = g.index_on("cpu")
    box = xf[:, ih[:, None], iw[None, :]]
    bkeys, hist = ksb.box_keys(Cplx(box.real.contiguous(),
                                    box.imag.contiguous()),
                               g.psi_on("cpu"), g.box_mats_on(h, w, "cpu"),
                               h, w)
    assert hist.shape == (2, lg, kp.HIST_COLS)
    assert torch.equal(hist, kp.key_histogram_plain(bkeys))


def test_radix_replay_nan_segment():
    keys = torch.rand(2, 3, 12, 12)
    keys[1, 2, 4, 4] = float("nan")
    q = torch.full((2, 3), 80.0)
    want = _reference(keys, q)
    got = torch.stack([_radix_select(keys[i, j], 80.0) for i in range(2)
                       for j in range(3)]).reshape(2, 3)
    assert torch.isnan(got[1, 2]) and torch.isnan(want[1, 2])
    assert torch.equal(got[~torch.isnan(got)], want[~torch.isnan(want)])


def test_radix_replay_above_2_pow_24():
    """n − 1 rounds in float32 above 2**24, and the rank clamps to n − 1."""
    n = (1 << 24) + 3
    keys = torch.rand(1, 1, 1, n)
    for q in (100.0, 99.99999, 50.0):
        qq = torch.tensor([[q]])
        want = _reference(keys, qq)
        got = _radix_select(keys[0, 0], q)
        assert got.view(torch.int32) == want.view(torch.int32)[0, 0]


@pytest.mark.parametrize("q", [0.0, 37.5, 60.0, 99.9, 100.0])
def test_host_selection_equals_sort(q):
    """``_percentile_from_mag`` selects on the host when every slice asks
    for one rank: bit-equal to its sort, with ties and a NaN slice."""
    rng = np.random.default_rng(int(q * 10))
    mag = torch.from_numpy(rng.uniform(size=(6, 20, 30)).astype(np.float32))
    mag[2] = torch.round(mag[2] * 4)
    mag[4, 3, 3] = float("nan")
    same = threshold._percentile_from_mag(mag, torch.full((6,), q))
    # a per-slice q that differs in one slice takes the sort
    qs = torch.full((7,), q)
    qs[6] = 50.0
    sorted_ = threshold._percentile_from_mag(
        torch.cat([mag, mag[:1]]), qs)[:6]
    assert torch.equal(same.view(torch.int32), sorted_.view(torch.int32))


def test_band_percentile_plain_on_cpu():
    keys = torch.rand(2, 3, 9, 11)
    q = torch.full((2, 3), 75.0)
    assert torch.equal(kp.band_percentile(keys, q),
                       kp.band_percentile_plain(keys, q))
    with pytest.raises(ValueError, match="keys must be"):
        kp.band_percentile(keys, q[:1])


def test_driver_budget_counts_the_keys():
    """The 48 full-size SHEARLET bands at 512² hold more keys than any of
    its box groups; the budget counts their keys with the selection's
    histogram, candidates and state, and the c_l pass 1 keeps."""
    tr = get_transform("SHEARLET")
    base = pipe._transform_device_bytes(tr, 32, 512, 512)
    pct = pipe._transform_device_bytes(tr, 32, 512, 512, "hard-percentile")
    assert pct - base == (ksb.percentile_key_bytes(32, 512, 512, 48)
                          + ksb.kept_cl_bytes(32, 512, 512, 48))
    segments = 32 * 48
    assert ksb.percentile_key_bytes(32, 512, 512, 48) == (
        4 * segments * 512 * 512 + 4 * segments * kp.HIST_COLS
        + kp.select_bytes(segments, 512 * 512))
    assert ksb.kept_cl_bytes(32, 512, 512, 48) == 8 * segments * 512 * 512
    # the largest chunk's kept c_l, what a call allocates, stays inside it
    sup = ksb.row_support_on(sh._plan_kernel_pack(
        tr._plan(512, 512), 512, 512)[0].psi, "cpu")
    chunks = sup.chunks(32, 512, 512)[0]
    kept = 8 * 32 * int(np.max(np.diff(chunks))) * 512 * 512
    assert kept <= ksb.kept_cl_bytes(32, 512, 512, 48)


def test_route_describes_as_jax():
    for kind in ("SHEARLET", "CURVELET"):
        # the JAX package's Pallas route on, as its production default
        cfg = jpocs.POCSConfig(**META, niter=2, use_pallas=True,
                               pallas_interpret=True,
                               thresh_op="garrote-percentile",
                               transform_kind=kind)
        jrt = jpocs.solver_route((2, 64, 64), (64, 64), cfg, jget(kind))
        rt = pocs.solver_route((2, 64, 64), (64, 64), pocs.POCSConfig(
            **META, niter=2, thresh_op="garrote-percentile",
            transform_kind=kind))
        assert tuple(rt) == tuple(jrt) and pocs.runs(rt)
        assert pocs.describe_route(rt) == f"streamed-subband — {jrt.reason}"
