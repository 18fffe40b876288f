"""The DCT solve's line schedule (``csrc/pocs_solve.cu``, the three line
passes with ``DCT``), on the CPU.

The kernel computes the orthonormal DCT-II of a line z of length n with
Makhoul's fast DCT around the line engine's FFT: it loads the line
reordered, v[m] = z[2m] and v[n − 1 − m] = z[2m + 1], takes V = FFT(v), and
pairs each element with its mirror, X_k = f_k·V_k + conj(f_k)·V_{n−k}
(``dct_twiddles``: f_k = (c_k/2)·exp(−iπk/2n)). Back, V_k = g_k·(X_k −
i·X_{n−k}) (no second term at k = 0; g_k = exp(iπk/2n)/c_k), the unscaled
inverse FFT and the samples stored where they came from give n times the
DCT-III. Pass (a) runs the forward step along W, pass (b) along H the
forward step, the shrink and the inverse step at once (from A = f_k·V_k and
B = conj(f_k)·V_{n−k}: X_k = A + B, X_{n−k} = i·(A − B), and the
inverse's input g_k·((s_k + s_{n−k})·A + (s_k − s_{n−k})·B) with the
shrink factors s), pass (c) the inverse step along W with the scale
1/(H·W) and the reinsertion at the reordered samples.

These tests replay that schedule with ``torch.fft`` and hold it against
the dense ``dft.dct2_matrix`` products at even, odd, power-of-two and other
lengths, against ``pocs_solve_plain(basis='dct')`` as a whole solve, and
against the JAX package's ``pocs_solve_fused(basis='dct')`` in interpret
mode; they also check the twiddle table and the scratch the wrapper
allocates.

Tolerances: the replay and the matrix products are both float32 and differ
by the rounding of differently ordered sums: a line within 1e-5 of its
largest coefficient. Whole solves with soft and garrote thresholds, which
are continuous, within 1e-4 of max and √cost within 1e-6; hard thresholds
flip coefficients at the threshold under reordered arithmetic, so those
solves are held by SNR against the truth, within 0.1 dB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.ops.pallas.pocs_iter import pocs_solve_fused
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops import dft
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.ops.kernels import pocs_solve as ks
from pseudo_3d_interpolation_torch.ops.kernels.pocs_solve import _shrink

torch.set_num_threads(2)

LINE_TOL = 1e-5
SOFT_TOL = 1e-4
SQRT_COST_ATOL = 1e-6
SNR_TOL_DB = 0.1
ALPHA = 0.75
LENGTHS = [8, 12, 97, 100, 130, 512]


def _order(n: int) -> torch.Tensor:
    """Makhoul's order: element e of the FFT's line is sample order[e]."""
    e = torch.arange(n)
    return torch.where(2 * e < n, 2 * e, 2 * (n - e) - 1)


def _mirror(x: torch.Tensor) -> torch.Tensor:
    """Element (n − k) mod n of the last axis at k."""
    n = x.shape[-1]
    return x[..., (-torch.arange(n)) % n]


def _tables(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    tab = torch.from_numpy(ks.dct_twiddles(n))
    tab = torch.complex(tab[:, 0], tab[:, 1])
    return tab[:n], tab[n:]


def _forward(z: torch.Tensor) -> torch.Tensor:
    """The forward step along the last axis: the DCT-II of each line."""
    f, _ = _tables(z.shape[-1])
    v = torch.fft.fft(z[..., _order(z.shape[-1])])
    return f * v + f.conj() * _mirror(v)


def _inverse(x: torch.Tensor) -> torch.Tensor:
    """The inverse step along the last axis: n times the DCT-III."""
    n = x.shape[-1]
    _, g = _tables(n)
    mirror = _mirror(x)
    mirror[..., 0] = 0
    v = torch.fft.ifft(g * (x - 1j * mirror), norm="forward")
    out = torch.empty_like(v)
    out[..., _order(n)] = v
    return out


def _shrink_step(z: torch.Tensor, tau, op: str) -> torch.Tensor:
    """Pass (b)'s column along the last axis: the forward step, the shrink
    of X_k and X_{n−k} from one pairing, the inverse step."""
    n = z.shape[-1]
    f, g = _tables(n)
    v = torch.fft.fft(z[..., _order(n)])
    a, b = f * v, f.conj() * _mirror(v)
    x, y = a + b, a - b
    sk = _shrink(x.real ** 2 + x.imag ** 2, tau, op)
    sm = _shrink(y.real ** 2 + y.imag ** 2, tau, op)
    v = torch.fft.ifft(g * ((sk + sm) * a + (sk - sm) * b), norm="forward")
    out = torch.empty_like(v)
    out[..., _order(n)] = v
    return out


def _iteration(y: torch.Tensor, tau: torch.Tensor, op: str) -> torch.Tensor:
    """The three passes of one iteration before the reinsertion: H·W times
    the DCT-III of the shrunk DCT-II of y (B, H, W)."""
    t = _forward(y)                                          # (a) rows
    t = _shrink_step(t.transpose(-1, -2), tau[:, None, None],
                     op).transpose(-1, -2)                   # (b) columns
    return _inverse(t)                                       # (c) rows


def _replay_solve(obs: Cplx, mask, decay, op, version):
    """The kernel's solve: its passes and the FPOCS state of
    ``pocs_solve_plain``, from the same initial state."""
    z0 = torch.complex(obs.re, obs.im)
    b, h, w = z0.shape
    scale = 1.0 / (h * w)
    keep = 1.0 - ALPHA * mask
    x = x_prev = z0
    v = torch.ones(b)
    cost_prev = torch.full((b,), float("inf"))
    for j in range(decay.shape[0]):
        v1 = (1.0 + torch.sqrt(1.0 + 4.0 * v * v)) / 2.0
        f = (v - 1.0) / (v1 + 1.0) if version == "fast" else 0.0 * v
        y = x + f[:, None, None] * (x - x_prev)
        new = _iteration(y, decay[j], op) * scale * keep + ALPHA * z0
        mag = new.abs()
        d = torch.sum(mag - x.abs(), dim=(-2, -1))
        s = torch.sum(mag, dim=(-2, -1))
        cost = d * d / torch.where(s == 0, torch.ones_like(s), s * s)
        if version == "fast":
            restart = cost > cost_prev
            x_prev = torch.where(restart[:, None, None], new, x)
            v = torch.where(restart, torch.ones_like(v1), v1)
        else:
            x_prev, v = x, v1
        x, cost_prev = new, cost
    return x, cost


def _lines(n: int, real: bool, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(6, n)) + (0 if real else 1j) * rng.normal(
        size=(6, n))
    return torch.from_numpy(z.astype(np.complex64))


@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
@pytest.mark.parametrize("n", LENGTHS)
def test_forward_step_matches_the_matrix(n, real):
    z = _lines(n, real, n)
    c = torch.from_numpy(dft.dct2_matrix(n)).double()
    want = z.to(torch.complex128) @ c.T.to(torch.complex128)
    got = _forward(z)
    assert (got - want).abs().max() <= LINE_TOL * want.abs().max()
    if real:
        assert got.imag.abs().max() <= LINE_TOL * want.abs().max()


@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
@pytest.mark.parametrize("n", LENGTHS)
def test_inverse_step_matches_the_matrix(n, real):
    x = _lines(n, real, n + 1)
    c = torch.from_numpy(dft.dct2_matrix(n)).double()
    want = x.to(torch.complex128) @ c.to(torch.complex128)
    got = _inverse(x) / n
    assert (got - want).abs().max() <= LINE_TOL * want.abs().max()


@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("n", LENGTHS)
def test_shrink_step_is_the_three_steps(n, op):
    """Pass (b)'s single pairing against the forward step, the shrink of
    the natural coefficients and the inverse step; the hard threshold at
    a gap between the magnitudes."""
    z = _lines(n, False, n + 2)
    coef = _forward(z)
    mags = coef.abs()
    tau = torch.quantile(mags, 0.7, dim=-1, keepdim=True)
    if op == "hard":
        srt = mags.sort(dim=-1).values
        k = int(0.7 * n)
        tau = ((srt[:, k - 1] + srt[:, k]) / 2)[:, None]
    want = _inverse(coef * _shrink(coef.real ** 2 + coef.imag ** 2, tau,
                                   op))
    got = _shrink_step(z, tau, op)
    assert (got - want).abs().max() <= LINE_TOL * want.abs().max()


def _inputs(b, h, w, niter, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((b, h, w), np.complex64)
    for i in range(b):
        for _ in range(4):
            fy, fx = rng.integers(1, 12, size=2)
            truth[i] += rng.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * rng.uniform(0, 6.28))
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=w) < 0.5)[None, :], (h, w)), np.float32)
    obs = (truth * mask).astype(np.complex64)
    z = Cplx(torch.from_numpy(np.ascontiguousarray(obs.real)),
             torch.from_numpy(np.ascontiguousarray(obs.imag)))
    tr = get_transform("DCT")
    decay = tr.decay(tr.forward(z), "exponential", niter, 0.99, 1e-3,
                     "values").contiguous()
    return truth, obs, z, torch.from_numpy(mask), decay


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


def _agree(got, want, op, truth):
    if op == "hard":
        assert abs(_snr(truth, got) - _snr(truth, want)) < SNR_TOL_DB
    else:
        assert np.abs(got - want).max() <= SOFT_TOL * np.abs(want).max()


@pytest.mark.parametrize("op", ["soft", "garrote", "hard"])
@pytest.mark.parametrize("version", ["regular", "fast"])
@pytest.mark.parametrize("h,w", [(64, 64), (48, 80), (37, 50)],
                         ids=["64", "48x80", "odd-37x50"])
def test_schedule_solve_matches_plain(h, w, version, op):
    truth, _, z, mask, decay = _inputs(2, h, w, 6, seed=h + w)
    got, cost = _replay_solve(z, mask, decay, op, version)
    want, want_cost = ks.pocs_solve_plain(z, mask, decay, ALPHA, op,
                                          version, basis="dct")
    want = torch.complex(want.re, want.im)
    _agree(got.numpy(), want.numpy(), op, truth)
    if op != "hard":
        np.testing.assert_allclose(np.sqrt(cost.numpy()),
                                   np.sqrt(want_cost.numpy()), rtol=0,
                                   atol=SQRT_COST_ATOL)


@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("h,w", [(128, 128), (128, 256)],
                         ids=["128", "rect-128x256"])
def test_schedule_solve_matches_jax_kernel(h, w, op):
    truth, obs, z, mask, decay = _inputs(2, h, w, 6, seed=3)
    want, want_cost = pocs_solve_fused(
        JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag)), mask.numpy(),
        decay.numpy(), alpha=ALPHA, thresh_op=op, version="fast",
        interpret=True, basis="dct")
    got, cost = _replay_solve(z, mask, decay, op, "fast")
    _agree(got.numpy(), np.asarray(want.re) + 1j * np.asarray(want.im), op,
           truth)
    if op != "hard":
        np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost),
                                   rtol=1e-3)


@pytest.mark.parametrize("n", LENGTHS)
def test_dct_twiddles_are_built_in_float64_and_rounded_once(n):
    k = np.arange(n, dtype=np.float64)
    c = np.where(k == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
    ang = np.pi * k / (2 * n)
    f = np.stack([c / 2 * np.cos(ang), -c / 2 * np.sin(ang)], -1)
    g = np.stack([np.cos(ang) / c, np.sin(ang) / c], -1)
    tab = ks.dct_twiddles(n)
    assert tab.dtype == np.float32 and tab.shape == (2 * n, 2)
    np.testing.assert_array_equal(tab, np.concatenate([f, g]).astype(
        np.float32))
    assert ks.dct_twiddles_on(n, "cpu").numpy().tobytes() == tab.tobytes()


@pytest.mark.parametrize("h,w", [(512, 512), (100, 130), (97, 130),
                                 (8, 4096)])
def test_dct_solve_scratch_is_the_fft_solves(h, w):
    """Two plane pairs and one partial-sum pair per row block of pass (c),
    as the FFT solve: the same count for every shape."""
    for b in (1, 32):
        assert ks.solve_work_floats(b, h, w, "dct") == \
            ks.solve_work_floats(b, h, w, "fft")
